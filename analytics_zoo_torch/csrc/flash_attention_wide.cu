// Flash-attention forward on float32 inputs at head_dim 320 to 2048
// (multiples of 64) for Hopper (sm_90a), every product on the tensor cores
// in split TF32 (flash_tile.cuh: x = hi + lo, three mma.sync.m16n8k8 TF32
// products a tile product, float32 accumulation).  flash_attention_fwd.cu
// takes head_dim 64 to 256, where one 16-row warp tile of O fits in
// registers.  The backward at these widths (dQ and dK/dV) is
// flash_attention_wide_bwd.cu: a cluster design of its own.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_kernel at
//           these widths (launched from _flash_fwd_impl).
//
// Computes, per (batch*head) slice laid out (BH, T, D), what
// flash_attention_fwd.cu computes: O = softmax(s) V and LSE = m +
// log(max(l, 1e-30)), s = (q * scale) k^T, causal keys after the query at
// -1e30.
//
// Head_dim is an argument, not a template parameter: one instance takes
// every width, as loops over 64-column chunks of d.
//
// What bounds it on the H100: at (8, 2, 512, 384), BERT-base's width in
// two heads, it must do 4*B*H*T^2*D = 6.44 GFLOP, taken as three TF32
// products at 495 TFLOP/s: 0.039 ms, against ~0.015 ms to move its bytes.
// It is bound by operations, as row 1 at (8, 12, 512, 64).
//
// Design.  At these widths one 16-row tile of O is D/2 registers a lane,
// 1024 at D = 2048, and one 16-row tile of q, K or V is up to 128 KB of
// shared memory.  So each block owns at most 256 of the output's columns
// (MAX_NC chunks of 64; 128 accumulator registers a lane, as
// flash_attention_fwd.cu's Cfg<256>), the grid's z splits the columns (n =
// D/64 chunks into ceil(n/4) column blocks as even as whole chunks allow:
// 320 = 3 + 2 chunks, 768 = 3 x 4, 2048 = 8 x 4), and every column block
// takes the scores over the whole of d:
//   scores(): x = (a * mul) b^T for a 64-row tile of a (q: 4 warps of 16
//   rows) against a 32-row tile of b (K), streaming a and b in 64-column
//   chunks through a two-stage cp.async ring; a b chunk is split into hi
//   (in place) and a lo plane as it lands, the a fragments in registers
//   (after the multiply by mul: q * scale in float32, as the reference
//   takes it).  The sum over d runs in 8-wide steps in order, each step's
//   three products from zero, added to the scores in float32
//   (flash_wide_tile.cuh's dots_chunk says why).
//   Every column block takes s with the same sequence of mma on the same
//   operands, so every column block reaches the same m and l, its O
//   columns agree, and block z = 0 alone writes LSE.
//   grid (T/64, BH, ceil(n/4)); a block owns 64 query rows and its columns;
//   for each 32-key tile it takes S (scores), the online softmax in
//   registers, and O += P V[:, its columns] from P's accumulator registers
//   (flash_tile.cuh's accumulate; V's columns land plain and are split as
//   read).
//   Recomputed work: with z column blocks, S is taken z times where once
//   would do: (z + 1) / 2 times the minimum (z = 2 at 384, 3 at 768, 8 at
//   2048: 1.5, 2 and 4.5 times).  The backward takes its scores once per
//   cluster of column blocks (flash_attention_wide_bwd.cu), so its s is not
//   this kernel's s bit for bit; both are within float32 rounding of it.
// Shared memory: the ring 69,632 bytes, V's columns 33,280: 102,912, two
// blocks an SM.  Registers (ptxas): 246 a thread, no spill.  No output
// element is written by two blocks and nothing is accumulated with
// atomics: two launches are bit-identical.  Rows and keys past T are
// zero-filled by the copies, get probability 0, and are not written;
// causal blocks stop at the last key tile any of their rows sees, and a
// warp whose rows see none of a tile's keys skips its products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wide_tile.cuh"

namespace {

using namespace flash_wide;

constexpr int FWD_BYTES = (RING + BN * OS) * (int)sizeof(float);
static_assert(FWD_BYTES <= 232448 / 2, "two blocks an SM on the H100");

// x = (a[a0 : a0+64] * mul) . b[b0 : b0+32]^T over all of d, this warp's 16
// rows (ra of the a tile) in m16n8 accumulators.  Collective: every thread
// of the block calls it (it loads and waits); warps not `live` skip the
// products.  It waits for every cp.async group this thread committed
// before it, and leaves the ring free.
__device__ __forceinline__ void scores(float x[NJ][4], float* ring, const float* a, int a0,
                                       const float* b, int b0, int t, int d, float mul,
                                       bool live, int ra, int g, int tg) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
    const int n = d / CH;
    load_rows<BM, CS>(ring, a, a0, t, d, 0, CH / 4);
    load_rows<BN, CS>(ring + A_TILE, b, b0, t, d, 0, CH / 4);
    cp_async_commit();
    for (int c = 0; c < n; ++c) {
        float* st = ring + (c & 1) * STAGE;
        if (c + 1 < n) {
            float* next = ring + ((c + 1) & 1) * STAGE;
            load_rows<BM, CS>(next, a, a0, t, d, (c + 1) * CH, CH / 4);
            load_rows<BN, CS>(next + A_TILE, b, b0, t, d, (c + 1) * CH, CH / 4);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        split_b(st + A_TILE, st + A_TILE + B_TILE);
        __syncthreads();
        // two steps unrolled: all eight left the kernel at 255 registers with
        // spills (measured with ptxas)
        if (live) dots_chunk<2, true>(x, st, ra, st + A_TILE, st + A_TILE + B_TILE, mul, g, tg);
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
}

// ------------------------------------------------------------- forward

__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int t, int d, float scale, int causal) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    float* vt = ring + RING;                       // V's columns of a key tile, plain

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 16 * warp;
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BM;
    const int row0 = q0 + r0;                      // this warp's first row
    const size_t base = (size_t)bh * t * d;
    int c0, nc;
    my_chunks(d, c0, nc);

    int n_k = (t + BN - 1) / BN;
    if (causal) {
        const int last = (q0 + BM + BN - 1) / BN;  // tiles any row of this block sees
        n_k = n_k < last ? n_k : last;
    }

    // rows g (h = 0) and g + 8 (h = 1) of this warp's 16
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    float acc[MAX_NC][CH / 8][4];
    zero_acc(acc);

    for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * BN;
        load_rows<BN, OS>(vt, v + base, k0, t, d, c0 * CH, nc * CH / 4);
        cp_async_commit();
        // causal: a warp whose rows all lie above this tile's keys skips it
        const bool live = row0 < t && !(causal && k0 > row0 + 15);
        float p[NJ][4];
        scores(p, ring, q + base, q0, k + base, k0, t, d, scale, live, r0, g, tg);
        if (live) {
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
            for (int c = 0; c < MAX_NC; ++c) {
                if (c >= nc) break;
#pragma unroll
                for (int n = 0; n < CH / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[c][n][e] *= corr[e >> 1];
                accumulate<OutChunk, true>(acc[c], p, vt + c * CH, nullptr, g, tg);
            }
        }
        __syncthreads();   // every warp is done with V's tile before it is refilled
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int row = row0 + g + 8 * h;
        if (row >= t) continue;
        const float l_safe = fmaxf(l[h], 1e-30f);
        if (blockIdx.z == 0 && tg == 0) lse[(size_t)bh * t + row] = m[h] + logf(l_safe);
        float* orow = o + base + (size_t)row * d + c0 * CH + 2 * tg;
#pragma unroll
        for (int c = 0; c < MAX_NC; ++c) {
            if (c >= nc) break;
#pragma unroll
            for (int n = 0; n < CH / 8; ++n)
                *reinterpret_cast<float2*>(orow + c * CH + 8 * n) =
                    make_float2(acc[c][n][2 * h] / l_safe, acc[c][n][2 * h + 1] / l_safe);
        }
    }
}

// ------------------------------------------------------------- launches

template <class K>
cudaError_t smem(K kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int zoo_flash_attention_fwd_wide(const float* q, const float* k,
                                            const float* v, float* o, float* lse,
                                            int bh, int t, int d, float scale,
                                            int causal, void* stream) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    cudaError_t err = smem(flash_fwd_wide_kernel, FWD_BYTES);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_wide_kernel<<<grid(t, BM, bh, d), NTHREADS, FWD_BYTES,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
        q, k, v, o, lse, t, d, scale, causal);
    return (int)cudaGetLastError();
}

