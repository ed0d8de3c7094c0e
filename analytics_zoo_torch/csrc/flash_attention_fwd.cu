// Flash-attention forward for Hopper (sm_90a) on float32 inputs, both
// products on the tensor cores in split TF32.  The bfloat16 forward is
// flash_attention_fwd_bf16.cu (wgmma, TMA and mbarriers).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_kernel
//           (launched from _flash_fwd_impl).
//
// Computes, for each (batch*head) slice of q, k, v laid out (BH, T, D):
//   O   = softmax(scale * q k^T) v        (causal: keys after the query
//                                          masked to -1e30, not -inf)
//   LSE = m + log(max(l, 1e-30))          per query row, float32
// with the reference's order of operations: q is multiplied by `scale` in
// float32 before the dot; an online softmax keeps the running max m
// (starting at -1e30) and sum l in float32 across K/V tiles, rescaling the
// O accumulator by exp(m_old - m_new) once a tile; O = acc / max(l, 1e-30);
// causal blocks stop at the last tile any of their rows sees.
//
// Precision: S = (q*scale) K^T and O += P V each as three
// mma.sync.m16n8k8 TF32 products on hi and lo parts, float32
// accumulation (flash_tile.cuh), which keeps about float32's accuracy.
// s is taken by flash_tile.cuh's dots, with q scaled in float32 and split
// as the A operand and the split K tile as B, exactly as the dQ kernel
// (flash_attention_bwd.cu) recomputes it: the same 8-wide steps over d in
// the same order, so the dQ kernel's s is this kernel's bit for bit,
// whatever the two tilings.
//
// What bounds it on the H100: at the serving shape (8, 12, 512, 64) it
// does 4*B*H*T^2*D = 6.44 GFLOP on 50 MB of q, k, v, O and LSE; taken as
// three TF32 products at 495 TFLOP/s that is 0.039 ms, against 0.015 ms to
// move the bytes: bound by operations.  BERT-base's width in 3 heads of 256
// or 4 of 192, (8, 3, 512, 256) and (8, 4, 512, 192), keeps H*D = 768 and
// with it the same operations and bytes.  As in the backward, a streamed K or
// V tile is split once, as it lands, and only the A operands (q*scale, P)
// are split in registers.
//
// Design: one block per (bh, BM-row q tile); each of its BM/16 warps owns
// 16 q rows.  BN-row K and V tiles stream through a two-stage cp.async ring
// (the next tile loads while this one is used); a landed tile is split in
// place into its hi part and a lo plane.  S comes out as m16n8
// accumulators; the row max is reduced over the 4 lanes of a row with two
// shuffles, P = exp(s - m_new) is formed in those registers and feeds
// O += P V as the A operand directly (flash_tile.cuh's accumulate).  The O
// accumulator, D/8 m16n8 tiles (32 registers at D=64, 64 at D=128), is
// rescaled by corr once a tile.  Each lane keeps its part of l, the sum
// over its own columns, rescaled by the row's corr as the tile goes; the
// 4 lanes of a row add their parts once, at the end.  A warp whose rows
// all lie above a tile's keys (causal) or past T skips the tile.  Keys past
// T in a ragged last tile are zero-filled by the copy and get probability
// 0; rows past T are not written.  No output element is written by two
// blocks: two launches give bit-identical O and LSE.
//   D=64: BM=128 (8 warps), BN=32: 85 KB of shared memory and at most 128
//   registers a thread, so two blocks (16 warps) share an SM; D=128:
//   BM=64 (4 warps), BN=32, 132 KB, one block an SM.
//   D=192 and 256: one lane's O accumulator is 96 or 128 registers, and a
//   warp's S, at few keys a tile, is a short row of chains of dependent
//   mma (96 in a chain at D=256): the time goes to their latency, so the
//   design puts two warps on each sub-partition (BM=128, 8 warps) and as
//   many keys a tile as shared memory holds.  To make room, K keeps no lo
//   plane: each warp splits its K fragments as it reads them (K_LO false;
//   flash_tile.cuh's RAW_B), to the parts split_own would store, so s is
//   still the dQ kernel's bit for bit.  D=192: BN=32, (128 + 5*32) rows
//   of 196 floats, 225,792 bytes; D=256: BN=16, (128 + 5*16) rows of 260
//   floats, 216,320 bytes (BN=32 would take 266,240 even at BM=64 with
//   both lo planes, over the 232,448 a block may have).  One block an SM;
//   ptxas gives 241 and 253 registers a thread, no spill.
//   scripts/bench_flash.py --wide --diagnose times these against the
//   earlier tilings (WIDE_VARIANTS).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

using namespace flash_tile;

template <int D_>
struct Cfg {
    static constexpr int D = D_;
    static constexpr int BM = D == 128 ? 64 : 128;  // q rows a block owns
    static constexpr int BN = D <= 192 ? 32 : 16;   // keys of each streamed tile
    // K split as it lands into a lo plane; else (no room) as it is read
    static constexpr bool K_LO = D <= 128;
    static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;  // blocks an SM (__launch_bounds__)
    static constexpr int NTHREADS = 32 * (BM / 16);
    static constexpr int NJ = BN / 8;              // m16n8 tiles across a streamed tile
    static constexpr int S = D + 4;                // padded row stride, floats
    static constexpr int OWN = BM * S;             // floats in the q tile
    static constexpr int TILE = BN * S;            // floats in one streamed tile
    // q; ring: two stages of K and V (V split in place to its hi part, K
    // too where K_LO); (K_LO) the K lo plane; the V lo plane
    static constexpr int BYTES = (OWN + (K_LO ? 6 : 5) * TILE) * (int)sizeof(float);
    static_assert(BYTES <= 232448, "a block's shared memory on the H100");
};

template <class C>
__global__ void __launch_bounds__(C::NTHREADS, C::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t, float scale, int causal) {
    constexpr int D = C::D, BM = C::BM, BN = C::BN, NJ = C::NJ;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);
    float* ring = qs + C::OWN;                     // stage s: K at 2s, V at 2s+1
    float* k_lo = C::K_LO ? ring + 4 * C::TILE : nullptr;
    float* v_lo = ring + (C::K_LO ? 5 : 4) * C::TILE;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 16 * warp;
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BM;
    const int row0 = q0 + r0;                      // this warp's first row
    const size_t base = (size_t)bh * t * D;

    int n_k = (t + BN - 1) / BN;
    if (causal) {
        const int last = (q0 + BM + BN - 1) / BN;  // tiles any row of this block sees
        n_k = n_k < last ? n_k : last;
    }

    load_tile<C, BM>(qs, q + base, q0, t);
    load_tile<C, BN>(ring, k + base, 0, t);
    load_tile<C, BN>(ring + C::TILE, v + base, 0, t);
    cp_async_commit();

    // rows g (h = 0) and g + 8 (h = 1) of this warp's 16
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
        float* ks = ring + (kt & 1) * 2 * C::TILE;
        float* vs = ks + C::TILE;
        if (kt + 1 < n_k) {
            float* next = ring + ((kt + 1) & 1) * 2 * C::TILE;
            load_tile<C, BN>(next, k + base, (kt + 1) * BN, t);
            load_tile<C, BN>(next + C::TILE, v + base, (kt + 1) * BN, t);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        if (kt == 0) scale_own<C>(qs, scale);
        if (C::K_LO) split_own<C>(ks, k_lo, 1.f);
        split_own<C>(vs, v_lo, 1.f);
        __syncthreads();

        const int k0 = kt * BN;
        // causal: a warp whose rows all lie above this tile's keys skips it
        if (row0 < t && !(causal && k0 > row0 + 15)) {
            float p[NJ][4];
            dots<C, !C::K_LO>(p, qs, r0, ks, k_lo, g, tg);
            // keys past T get s = -inf: no part in the max, p = exp(-inf) = 0
            // (m is finite from its start at -1e30)
            if (k0 + BN > t || (causal && k0 + BN - 1 > row0)) {
#pragma unroll
                for (int j = 0; j < NJ; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int row = row0 + g + 8 * (e >> 1);
                        const int col = k0 + 8 * j + 2 * tg + (e & 1);
                        if (col >= t) p[j][e] = -INFINITY;
                        else if (causal && col > row) p[j][e] = -1e30f;
                    }
            }
            float mb[2] = {-1e30f, -1e30f};
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], p[j][e]);
            float corr[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 1));
                mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 2));
                const float m_new = fmaxf(m[h], mb[h]);
                corr[h] = expf(m[h] - m_new);
                m[h] = m_new;
            }
            float ls[2] = {0.f, 0.f};
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    p[j][e] = expf(p[j][e] - m[e >> 1]);
                    ls[e >> 1] += p[j][e];
                }
#pragma unroll
            for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
            accumulate<C>(acc, p, vs, v_lo, g, tg);
        }
        __syncthreads();   // every warp is done with this stage before it is refilled
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int row = row0 + g + 8 * h;
        if (row >= t) continue;
        const float l_safe = fmaxf(l[h], 1e-30f);
        float* orow = o + base + (size_t)row * D + 2 * tg;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<float2*>(orow + 8 * n) =
                make_float2(acc[n][2 * h] / l_safe, acc[n][2 * h + 1] / l_safe);
        if (tg == 0) lse[(size_t)bh * t + row] = m[h] + logf(l_safe);
    }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int t, float scale, int causal,
                   cudaStream_t stream) {
    using C = Cfg<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((t + C::BM - 1) / C::BM, bh);
    flash_fwd_kernel<C><<<grid, C::NTHREADS, C::BYTES, stream>>>(q, k, v, o, lse, t,
                                                                scale, causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" int zoo_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int bh, int t, int d, float scale,
                                       int causal, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    switch (d) {
        case 64:
            return (int)launch<64>(q, k, v, o, lse, bh, t, scale, causal, s);
        case 128:
            return (int)launch<128>(q, k, v, o, lse, bh, t, scale, causal, s);
        case 192:
            return (int)launch<192>(q, k, v, o, lse, bh, t, scale, causal, s);
        case 256:
            return (int)launch<256>(q, k, v, o, lse, bh, t, scale, causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
