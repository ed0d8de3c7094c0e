// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV in float32,
// with every product on the tensor cores in split TF32.  The bfloat16
// backward is flash_attention_bwd_bf16.cu.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_dq_kernel
//           and ::_flash_dkv_kernel (launched from _flash_vjp_bwd).
//
// Both kernels recompute, per (query row i, key row j) of one (batch*head)
// slice laid out (BH, T, D), the forward's probabilities from its saved
// log-sum-exp:
//   s_ij  = (q_i * scale) . k_j         (q scaled in float32 first; causal:
//                                         s = -1e30 where j > i, not -inf)
//   p_ij  = exp(s_ij - lse_i)
//   dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)     delta_i = rowsum(do_i * o_i), from
//                                         the caller (a PyTorch op, as the
//                                         reference leaves it to XLA)
// and then
//   dq_i = scale * sum_j ds_ij k_j                       (zoo_flash_attention_dq)
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij (scale*q_i) (zoo_flash_attention_dkv)
// The forward kernel (flash_attention_fwd.cu) takes s with the same code
// (flash_tile.cuh's dots, q scaled in float32 and split as the A operand,
// the split K tile as B), so the dQ kernel's recomputed s is the forward's
// bit for bit, whatever either kernel's tiling: each s is summed over d in
// the same 8-wide steps in the same order.  dK/dV takes S^T with K as the
// A operand, so its lo.hi and hi.lo terms come in the other order and its
// s may differ from the forward's by float32 rounding (~1e-7 relative).
//
// Precision: split TF32, every product as three mma.sync.m16n8k8 TF32
// instructions on hi and lo parts (flash_tile.cuh says how); the five
// products (S, dP, dQ, dV, dK) keep about float32's accuracy.
//
// What bounds them on the H100: at the training shape (8, 12, 512, 64) dQ
// does 6*B*H*T^2*D = 9.66 GFLOP and dK/dV 8*B*H*T^2*D = 12.88 GFLOP on
// ~63 and ~75 MB of operands.  Taken as three TF32 products at 495 TFLOP/s
// that is 0.0586 and 0.0781 ms, against 0.019 and 0.023 ms to move the
// bytes: both are bound by operations.  Splitting an operand costs four or
// five ALU instructions; three mma take one B fragment (two values) and
// share the A fragment across a row of tiles, so a B operand split by
// every warp that reads it would cost more issue slots than the mma.  The
// design therefore splits each streamed tile once, as it lands, and keeps
// only the A operands' split in registers.
//
// Design.  Blocks of a CUDA grid run in no order, so no output element is
// written by two blocks and nothing is accumulated with atomics: two
// launches on the same inputs give bit-identical outputs.
//   dQ:    one block per (bh, BM-row q tile); each of its BM/16 warps owns
//          16 q rows.  BN-row K and V tiles stream through a two-stage
//          cp.async ring (the next tile loads while this one is used); a
//          landed tile is split in place into its hi part and a lo plane.
//          S = (q*scale) K^T and dP = dO V^T come out as m16n8
//          accumulators; P and dS are formed in those registers and feed
//          dQ += dS K as the A operand directly.  Causal blocks stop at the
//          diagonal tile, and a warp whose rows all lie above a tile's keys
//          skips it.
//   dK/dV: one block per (bh, BM-row k tile), looping over the q tiles
//          itself (FA2 order); each warp owns 16 key rows.  It computes
//          S^T = K (q*scale)^T and dP^T = V dO^T, so P^T and dS^T come out
//          in key-row layout and feed dV += P^T dO and dK += dS^T (q*scale)
//          from registers; lse and delta become per-column values.  q, dO,
//          lse and delta stream through the two-stage ring.  Causal blocks
//          start at the diagonal tile, and a warp whose keys all lie past
//          a tile's queries skips it.
//   D=64: BM=128 (8 warps), BN=64; D=128: BM=64 (4 warps), BN=32, so that
//   the dK and dV accumulators (64 registers each at D=128) fit beside P
//   and dS, and the shared tiles fit in 227 KB.
// P and dS feed the next product as A operands from their accumulators,
// and fragment reads are free of bank conflicts (flash_tile.cuh).  Keys and
// queries past T in a ragged last tile are zero-filled by the copy and get
// probability 0; rows past T are not written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

using namespace flash_tile;

template <int D_>
struct Cfg {
    static constexpr int D = D_;
    static constexpr int BM = D == 64 ? 128 : 64;  // rows a block owns
    static constexpr int BN = D == 64 ? 64 : 32;   // rows of each streamed tile
    static constexpr int NWARPS = BM / 16;
    static constexpr int NTHREADS = 32 * NWARPS;
    static constexpr int NJ = BN / 8;              // m16n8 tiles across a streamed tile
    static constexpr int S = D + 4;                // padded row stride, floats
    static constexpr int OWN = BM * S;             // floats in the block's own tile
    static constexpr int TILE = BN * S;            // floats in one streamed tile
    // own: two tiles (q, dO or K, V); ring: two stages of two streamed
    // tiles (split in place to their hi parts); their two lo planes; dK/dV
    // also streams lse and delta (two stages of BN each)
    static constexpr int DQ_BYTES = (2 * OWN + 6 * TILE) * (int)sizeof(float);
    static constexpr int DKV_BYTES = (2 * OWN + 6 * TILE + 4 * BN) * (int)sizeof(float);
};

template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float acc[D / 8][4], int row0,
                                           int t, float mul, int g, int tg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        if (row >= t) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<float2*>(dst + (size_t)row * D + 8 * n + 2 * tg) =
                make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
}

// ------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int t, float scale, int causal) {
    using C = Cfg<D>;
    constexpr int BM = C::BM, BN = C::BN, NJ = C::NJ;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);
    float* dos = qs + C::OWN;
    float* ring = dos + C::OWN;                    // stage s: K at 2s, V at 2s+1
    float* k_lo = ring + 4 * C::TILE;
    float* v_lo = k_lo + C::TILE;

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
    load_tile<C, BM>(dos, dout + base, q0, t);
    load_tile<C, BN>(ring, k + base, 0, t);
    load_tile<C, BN>(ring + C::TILE, v + base, 0, t);
    cp_async_commit();

    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        lse_r[h] = row < t ? lse[(size_t)bh * t + row] : 0.f;
        delta_r[h] = row < t ? delta[(size_t)bh * t + row] : 0.f;
    }

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
        split_own<C>(ks, k_lo, 1.f);
        split_own<C>(vs, v_lo, 1.f);
        __syncthreads();

        const int k0 = kt * BN;
        // causal: a warp whose rows all lie above this tile's keys skips it
        if (row0 < t && !(causal && k0 > row0 + 15)) {
            float p[NJ][4], ds[NJ][4];
            dots<C>(p, qs, r0, ks, k_lo, g, tg);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = row0 + g + 8 * (e >> 1);
                    const int col = k0 + 8 * j + 2 * tg + (e & 1);
                    float sv = p[j][e];
                    if (causal && col > row) sv = -1e30f;
                    p[j][e] = (row < t && col < t) ? expf(sv - lse_r[e >> 1]) : 0.f;
                }
            dots<C>(ds, dos, r0, vs, v_lo, g, tg);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - delta_r[e >> 1]);
            accumulate<C>(acc, ds, ks, k_lo, g, tg);
        }
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
    store_rows<D>(dq + base, acc, row0, t, scale, g, tg);
}

// ---------------------------------------------------------------- dK/dV

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int t,
                 float scale, int causal) {
    using C = Cfg<D>;
    constexpr int BM = C::BM, BN = C::BN, NJ = C::NJ;
    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);
    float* vs = ks + C::OWN;
    float* ring = vs + C::OWN;                     // stage s: q at 2s, dO at 2s+1
    float* q_lo = ring + 4 * C::TILE;
    float* do_lo = q_lo + C::TILE;
    float* rows = do_lo + C::TILE;                 // stage s: lse at 2s, delta at 2s+1 (BN each)

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 16 * warp;
    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * BM;
    const int row0 = k0 + r0;                      // this warp's first key row
    const size_t base = (size_t)bh * t * D;
    const float* lse_bh = lse + (size_t)bh * t;
    const float* delta_bh = delta + (size_t)bh * t;

    const int n_q = (t + BN - 1) / BN;
    // causal: q tiles whose last row lies above this block's first key see
    // none of its keys
    const int qt0 = causal ? k0 / BN : 0;

    // q, dO, and one thread a value of lse (threads [0, BN)) and delta
    // ([BN, 2BN)); commits the group
    auto load_stage = [&](int qt, int stage) {
        float* st = ring + stage * 2 * C::TILE;
        load_tile<C, BN>(st, q + base, qt * BN, t);
        load_tile<C, BN>(st + C::TILE, dout + base, qt * BN, t);
        if (threadIdx.x < 2 * BN) {
            const int row = qt * BN + threadIdx.x % BN;
            const bool in = row < t;
            const float* src = threadIdx.x < BN ? lse_bh : delta_bh;
            cp_async4(rows + stage * 2 * BN + threadIdx.x, src + (in ? row : 0), in);
        }
        cp_async_commit();
    };

    load_tile<C, BM>(ks, k + base, k0, t);
    load_tile<C, BM>(vs, v + base, k0, t);
    load_stage(qt0, 0);                            // commits K and V with it

    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

    for (int qt = qt0; qt < n_q; ++qt) {
        const int stage = (qt - qt0) & 1;
        float* qs = ring + stage * 2 * C::TILE;
        float* dos = qs + C::TILE;
        const float* ls = rows + stage * 2 * BN;
        const float* dl = ls + BN;
        if (qt + 1 < n_q) {
            load_stage(qt + 1, stage ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        split_own<C>(qs, q_lo, scale);
        split_own<C>(dos, do_lo, 1.f);
        __syncthreads();

        const int q0 = qt * BN;
        // causal: a warp whose keys all lie past this tile's queries skips it
        if (row0 < t && !(causal && row0 > q0 + BN - 1)) {
            // this warp's key rows row0 + g (+8) against queries 8j + 2tg (+1)
            float p[NJ][4], ds[NJ][4];
            dots<C>(p, ks, r0, qs, q_lo, g, tg);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int qc = 8 * j + 2 * tg;
                const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int krow = row0 + g + 8 * (e >> 1);
                    const int qrow = q0 + qc + (e & 1);
                    float sv = p[j][e];
                    if (causal && krow > qrow) sv = -1e30f;
                    p[j][e] = (krow < t && qrow < t) ? expf(sv - ((e & 1) ? l2.y : l2.x)) : 0.f;
                }
            }
            accumulate<C>(dv_acc, p, dos, do_lo, g, tg);
            dots<C>(ds, vs, r0, dos, do_lo, g, tg);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tg);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    ds[j][e] = p[j][e] * (ds[j][e] - ((e & 1) ? d2.y : d2.x));
            }
            accumulate<C>(dk_acc, ds, qs, q_lo, g, tg);
        }
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
    store_rows<D>(dk + base, dk_acc, row0, t, 1.f, g, tg);
    store_rows<D>(dv + base, dv_acc, row0, t, 1.f, g, tg);
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int bh, int t, float scale, int causal,
                      cudaStream_t stream) {
    using C = Cfg<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((t + C::BM - 1) / C::BM, bh);
    flash_dq_kernel<D><<<grid, C::NTHREADS, C::DQ_BYTES, stream>>>(
        q, k, v, dout, lse, delta, dq, t, scale, causal);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int t, float scale,
                       int causal, cudaStream_t stream) {
    using C = Cfg<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKV_BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((t + C::BM - 1) / C::BM, bh);
    flash_dkv_kernel<D><<<grid, C::NTHREADS, C::DKV_BYTES, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, t, scale, causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" int zoo_flash_attention_dq(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* lse, const float* delta,
                                      float* dq, int bh, int t, int d,
                                      float scale, int causal, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    switch (d) {
        case 64:
            return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, t, scale,
                                      causal, s);
        case 128:
            return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, t, scale,
                                       causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" int zoo_flash_attention_dkv(const float* q, const float* k,
                                       const float* v, const float* dout,
                                       const float* lse, const float* delta,
                                       float* dk, float* dv, int bh, int t,
                                       int d, float scale, int causal,
                                       void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    switch (d) {
        case 64:
            return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                       scale, causal, s);
        case 128:
            return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                        scale, causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
