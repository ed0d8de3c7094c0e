// Flash attention on float32 inputs at head_dim 320 to 2048 (multiples of
// 64) for Hopper (sm_90a): the forward, dQ and dK/dV, every product on the
// tensor cores in split TF32 (flash_tile.cuh: x = hi + lo, three
// mma.sync.m16n8k8 TF32 products a tile product, float32 accumulation).
// flash_attention_fwd.cu and flash_attention_bwd.cu take head_dim 64 to
// 256, where one 16-row warp tile of O, dQ, dK or dV fits in registers.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_kernel,
//           ::_flash_dq_kernel and ::_flash_dkv_kernel at these widths
//           (launched from _flash_fwd_impl and _flash_vjp_bwd).
//
// Computes, per (batch*head) slice laid out (BH, T, D), what the narrow
// kernels compute (their sources give the formulas):
//   forward  O = softmax(s) V, LSE = m + log(max(l, 1e-30)),
//            s = (q * scale) k^T, causal keys after the query at -1e30;
//   dQ       dq = scale * sum_j ds_ij k_j;
//   dK/dV    dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij (scale * q_i);
// with p = exp(s - lse) and ds = p * (do . v - delta) recomputed in the
// backward from the forward's LSE and delta = rowsum(dO * O).
//
// Head_dim is an argument, not a template parameter: one instance of each
// kernel takes every width, as loops over 64-column chunks of d.
//
// What bounds them on the H100: at (8, 2, 512, 384), BERT-base's width in
// two heads, the forward must do 4*B*H*T^2*D = 6.44 GFLOP, dQ 9.66 and
// dK/dV 12.88, each taken as three TF32 products at 495 TFLOP/s:
// 0.039, 0.059 and 0.078 ms, against ~0.015-0.023 ms to move their bytes.
// They are bound by operations, as rows 1-3 at (8, 12, 512, 64).
//
// Design.  At these widths one 16-row tile of O (or dQ, dK, dV) is D/2
// registers a lane, 1024 at D = 2048, and one 16-row tile of q, K or V is
// up to 128 KB of shared memory.  So each block owns at most 256 of the
// output's columns (MAX_NC chunks of 64; 128 accumulator registers a lane,
// as flash_attention_fwd.cu's Cfg<256>), the grid's z splits the columns
// (n = D/64 chunks into ceil(n/4) column blocks as even as whole chunks
// allow: 320 = 3 + 2 chunks, 768 = 3 x 4, 2048 = 8 x 4), and every column
// block recomputes the scores over the whole of d:
//   scores(): x = (a * mul) b^T for a 64-row tile of a (q or dO: 4 warps
//   of 16 rows) against a 32-row tile of b (K or V), streaming a and b in
//   64-column chunks through a two-stage cp.async ring; a b chunk is split
//   into hi (in place) and a lo plane as it lands, the a fragments in
//   registers (after the multiply by mul: q * scale in float32, as the
//   reference takes it).  The sum over d runs in 8-wide steps in order,
//   each step's three products from zero, added to the scores in float32
//   (dots_chunk says why).
//   All three kernels take s = (q*scale) k^T through scores() on the same
//   64 x 32 tiles at the same offsets, so each s is the same sequence of
//   mma on the same operands in every kernel and every column block: the
//   backward's s is the forward's bit for bit (exp(s - lse) reproduces the
//   forward's P), and every column block of the forward reaches the same m
//   and l, so its O columns agree and block z = 0 alone writes LSE.
//   forward: grid (T/64, BH, ceil(n/4)); a block owns 64 query rows and its
//     columns; for each 32-key tile it takes S (scores), the online softmax
//     in registers, and O += P V[:, its columns] from P's accumulator
//     registers (flash_tile.cuh's accumulate; V's columns land plain and
//     are split as read).
//   dQ: the same grid; S and dP = dO V^T (scores, twice), P = exp(S - lse)
//     and dS in registers, dQ += dS K[:, its columns].
//   dK/dV: grid (T/32, BH, ceil(n/4)); a block owns 32 keys and its columns
//     of both dK and dV and streams 64-row q tiles: S and dP as the dQ
//     kernel takes them (query rows a warp), P and dS into shared memory,
//     then, its columns of q and dO streaming through the same ring a
//     64-column chunk at a time, warps 0-1 add P^T dO to dV and warps 2-3
//     dS^T (q*scale) to dK for 16 keys each, with P^T and dS^T read
//     transposed from shared memory as A operands.
//   Recomputed work: with z column blocks, S (and dP) is taken z times
//   where once would do: the forward does (z + 1) / 2 times its minimum,
//   dQ (2z + 1) / 3 and dK/dV (z + 1) / 2 (z = 2 at 384, 3 at 768, 8 at
//   2048: 1.5, 2 and 4.5 times for the forward).
// Shared memory: the ring 69,632 bytes; forward and dQ 102,912, dK/dV
// 88,064: two blocks an SM.  Registers (ptxas): forward 246, dQ 252,
// dK/dV 253 a thread, no spill.  No output element is written by two
// blocks and nothing is accumulated with atomics: two launches are
// bit-identical.  Rows and keys past T are zero-filled by the copies, get
// probability 0, and are not written; causal blocks stop at the last key
// tile any of their rows sees (dK/dV starts at the first q tile that sees
// its keys), and a warp whose rows see none of a tile's keys skips its
// products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

using namespace flash_tile;

constexpr int CH = 64;                  // columns of a chunk of d
constexpr int CS = CH + 4;              // padded row stride of a chunk tile, floats
constexpr int BM = 64;                  // rows of a query tile: 4 warps of 16
constexpr int BN = 32;                  // rows of a key tile
constexpr int NJ = BN / 8;              // m16n8 tiles across a key tile
constexpr int NTHREADS = 128;
constexpr int MAX_NC = 4;               // chunks of the output a block owns
constexpr int OS = MAX_NC * CH + 4;     // padded row stride of an output-column tile
constexpr int PS = BN + 4;              // padded row stride of a P or dS tile
constexpr int A_TILE = BM * CS;
constexpr int B_TILE = BN * CS;
constexpr int STAGE = A_TILE + 2 * B_TILE;  // a chunk; b chunk's hi part and lo plane
constexpr int RING = 2 * STAGE;
constexpr int FWD_BYTES = (RING + BN * OS) * (int)sizeof(float);
constexpr int DKV_BYTES = (RING + 2 * BM * PS) * (int)sizeof(float);
static_assert(2 * BM * CS <= STAGE, "a stage holds a chunk of q and of dO");
static_assert(FWD_BYTES <= 232448 / 2, "two blocks an SM on the H100");

// flash_tile.cuh's accumulate over one 64-column chunk of an output-column
// tile
struct OutChunk {
    static constexpr int D = CH;
    static constexpr int S = OS;
    static constexpr int NJ = BN / 8;
};

// Start copying rows [r0, r0 + ROWS) of a (t, d) slice, columns [col0,
// col0 + 4 * pieces), into a tile of row stride STRIDE; rows past t are
// zero-filled.  With ROWS * pieces a multiple of NTHREADS, every call gives
// a thread the same 16-byte pieces, so once its copies have landed it may
// rewrite them without a barrier.
template <int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int t,
                                          int d, int col0, int pieces) {
    for (int idx = threadIdx.x; idx < ROWS * pieces; idx += NTHREADS) {
        const int r = idx / pieces, c = (idx % pieces) * 4;
        const bool in = r0 + r < t;
        cp_async16(dst + r * STRIDE + c, src + (size_t)(in ? r0 + r : 0) * d + col0 + c, in);
    }
}

// Split this thread's own (landed) pieces of a b chunk: hi in place, lo
// into the lo plane.
__device__ __forceinline__ void split_b(float* hi, float* lo) {
    constexpr int P = CH / 4;
#pragma unroll
    for (int i = 0; i < BN * P / NTHREADS; ++i) {
        const int idx = threadIdx.x + i * NTHREADS;
        const int off = (idx / P) * CS + (idx % P) * 4;
        const float4 x = *reinterpret_cast<const float4*>(hi + off);
        uint4 h, l;
        split(x.x, h.x, l.x);
        split(x.y, h.y, l.y);
        split(x.z, h.z, l.z);
        split(x.w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
    }
}

// x[j] += (a[ra : ra+16, :64] * mul) . b[8j : 8j+8, :64]^T: one chunk of
// the scores, in 8-wide steps of d in order; a plain (split here), b a
// split chunk (hi part and lo plane).  Each step's three products start
// from zero and the step's sum is added to x in float32: the tensor core
// rounds the sum it accumulates toward zero, so a chain of all of d's
// steps in one accumulator drifts by a fraction of an ulp of x a product:
// on the H100 LSE then missed its 1e-5 by 1.1-1.3 times at D = 768 and
// 2.1-3.5 times at 2048, O its tolerance by up to 2.8 times (the variant
// `chained` of scripts/bench_flash.py --wider --diagnose), where a step's
// own sum drifts by ulps of itself and the adds round to nearest (LSE at
// most 0.36 of its tolerance, O 0.51).
__device__ __forceinline__ void dots_chunk(float x[NJ][4], const float* a, int ra,
                                           const float* bh, const float* bl, float mul,
                                           int g, int tg) {
    // two steps unrolled: all eight leave each kernel at 255 registers
    // with 20-64 bytes spilled (scripts/bench_flash.py --wider --diagnose)
#pragma unroll 2
    for (int d0 = 0; d0 < CH; d0 += 8) {
        const float* ap = a + (ra + g) * CS + d0 + tg;
        uint32_t ah[4], al[4];
        split(ap[0] * mul, ah[0], al[0]);
        split(ap[8 * CS] * mul, ah[1], al[1]);
        split(ap[4] * mul, ah[2], al[2]);
        split(ap[8 * CS + 4] * mul, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int o = (8 * j + g) * CS + d0 + tg;
            float step[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(step, ah, al, bh, bl, o, o + 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[j][e] += step[e];
        }
    }
}

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
        if (live) dots_chunk(x, st, ra, st + A_TILE, st + A_TILE + B_TILE, mul, g, tg);
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
}

// The output columns a block owns: chunks [c0, c0 + nc) of d's n, the
// column blocks as even as whole chunks allow.
__device__ __forceinline__ void my_chunks(int d, int& c0, int& nc) {
    const int n = d / CH, z = blockIdx.z, nz = gridDim.z;
    c0 = z * n / nz;
    nc = (z + 1) * n / nz - c0;
}

// Rows row0 + g (+8) of an accumulator over the block's columns, times mul.
__device__ __forceinline__ void store_cols(float* dst, const float acc[MAX_NC][CH / 8][4],
                                           int row0, int t, int d, int c0, int nc,
                                           float mul, int g, int tg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        if (row >= t) continue;
        float* drow = dst + (size_t)row * d + c0 * CH + 2 * tg;
#pragma unroll
        for (int c = 0; c < MAX_NC; ++c) {
            if (c >= nc) break;
#pragma unroll
            for (int n = 0; n < CH / 8; ++n)
                *reinterpret_cast<float2*>(drow + c * CH + 8 * n) =
                    make_float2(acc[c][n][2 * h] * mul, acc[c][n][2 * h + 1] * mul);
        }
    }
}

__device__ __forceinline__ void zero_acc(float acc[MAX_NC][CH / 8][4]) {
#pragma unroll
    for (int c = 0; c < MAX_NC; ++c)
#pragma unroll
        for (int n = 0; n < CH / 8; ++n) acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.f;
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

// ------------------------------------------------------------------ dQ

__global__ void __launch_bounds__(NTHREADS, 2)
flash_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int t, int d, float scale, int causal) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    float* kt_cols = ring + RING;                  // K's columns of a key tile, plain

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

    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        lse_r[h] = row < t ? lse[(size_t)bh * t + row] : 0.f;
        delta_r[h] = row < t ? delta[(size_t)bh * t + row] : 0.f;
    }

    float acc[MAX_NC][CH / 8][4];
    zero_acc(acc);

    for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * BN;
        load_rows<BN, OS>(kt_cols, k + base, k0, t, d, c0 * CH, nc * CH / 4);
        cp_async_commit();
        // causal: a warp whose rows all lie above this tile's keys skips it
        const bool live = row0 < t && !(causal && k0 > row0 + 15);
        float p[NJ][4], ds[NJ][4];
        scores(p, ring, q + base, q0, k + base, k0, t, d, scale, live, r0, g, tg);
        scores(ds, ring, dout + base, q0, v + base, k0, t, d, 1.f, live, r0, g, tg);
        if (live) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = row0 + g + 8 * (e >> 1);
                    const int col = k0 + 8 * j + 2 * tg + (e & 1);
                    float sv = p[j][e];
                    if (causal && col > row) sv = -1e30f;
                    const float pv = (row < t && col < t) ? expf(sv - lse_r[e >> 1]) : 0.f;
                    ds[j][e] = pv * (ds[j][e] - delta_r[e >> 1]);
                }
#pragma unroll
            for (int c = 0; c < MAX_NC; ++c) {
                if (c >= nc) break;
                accumulate<OutChunk, true>(acc[c], ds, kt_cols + c * CH, nullptr, g, tg);
            }
        }
        __syncthreads();   // every warp is done with K's tile before it is refilled
    }
    store_cols(dq + base, acc, row0, t, d, c0, nc, scale, g, tg);
}

// ---------------------------------------------------------------- dK/dV

// mma3_raw with b times mul (split here, as read)
__device__ __forceinline__ void mma3_raw_mul(float c[4], const uint32_t ah[4],
                                             const uint32_t al[4], const float* b,
                                             int o0, int o1, float mul) {
    uint32_t h0, l0, h1, l1;
    split(b[o0] * mul, h0, l0);
    split(b[o1] * mul, h1, l1);
    mma(c, al, __uint_as_float(h0), __uint_as_float(h1));
    mma(c, ah, __uint_as_float(l0), __uint_as_float(l1));
    mma(c, ah, __uint_as_float(h0), __uint_as_float(h1));
}

// acc[n] += w[:, kr : kr+16]^T . (x[:, 8n : 8n+8] * mul) summed over the BM
// rows of w and x: w a (BM x BN) tile of P or dS in query-row layout (its
// rows the k dimension, read transposed as the A operand), x a plain
// (BM x 64) chunk tile of the block's columns, split as read.  k-slots t
// and t+4 of a step are rows 2t and 2t+1, as accumulate's.
__device__ __forceinline__ void accumulate_t(float acc[CH / 8][4], const float* w, int kr,
                                             const float* x, float mul, int g, int tg) {
#pragma unroll
    for (int kk = 0; kk < BM / 8; ++kk) {
        const float* wp = w + (8 * kk + 2 * tg) * PS + kr + g;
        uint32_t ah[4], al[4];
        split(wp[0], ah[0], al[0]);        // key g,   k-slot t
        split(wp[8], ah[1], al[1]);        // key g+8, k-slot t
        split(wp[PS], ah[2], al[2]);       // key g,   k-slot t+4
        split(wp[PS + 8], ah[3], al[3]);   // key g+8, k-slot t+4
        const int o = (8 * kk + 2 * tg) * CS + g;
#pragma unroll
        for (int n = 0; n < CH / 8; ++n)
            mma3_raw_mul(acc[n], ah, al, x, o + 8 * n, o + CS + 8 * n, mul);
    }
}

__global__ void __launch_bounds__(NTHREADS, 2)
flash_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int t, int d,
                      float scale, int causal) {
    extern __shared__ float4 smem4[];
    // the ring: the scores' chunks, then the block's columns of q and dO
    // (a q tile's 64 rows of each, one 64-column chunk a stage)
    float* ring = reinterpret_cast<float*>(smem4);
    float* pt = ring + RING;                       // P of the q tile against the block's keys
    float* dst = pt + BM * PS;                     // dS, the same

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 16 * warp;                      // this warp's q rows in a q tile
    const bool takes_dv = warp < 2;                // dV for 16 keys; else dK
    const int kr = 16 * (warp & 1);                // those keys, in the block's 32
    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * BN;                // the block's first key
    const size_t base = (size_t)bh * t * d;
    const float* lse_bh = lse + (size_t)bh * t;
    const float* delta_bh = delta + (size_t)bh * t;
    int c0, nc;
    my_chunks(d, c0, nc);

    const int n_q = (t + BM - 1) / BM;
    // causal: q tiles whose last row lies above the block's first key see
    // none of its keys
    const int qt0 = causal ? k0 / BM : 0;

    float acc[MAX_NC][CH / 8][4];                  // dV in warps 0-1, dK in 2-3
    zero_acc(acc);

    for (int qt = qt0; qt < n_q; ++qt) {
        const int q0 = qt * BM;
        const int row0 = q0 + r0;                  // this warp's first q row
        float lse_r[2], delta_r[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + g + 8 * h;
            lse_r[h] = row < t ? lse_bh[row] : 0.f;
            delta_r[h] = row < t ? delta_bh[row] : 0.f;
        }
        // causal: a warp whose rows all lie above the block's keys sees none
        const bool live = row0 < t && !(causal && k0 > row0 + 15);
        float p[NJ][4], ds[NJ][4];
        scores(p, ring, q + base, q0, k + base, k0, t, d, scale, live, r0, g, tg);
        scores(ds, ring, dout + base, q0, v + base, k0, t, d, 1.f, live, r0, g, tg);
        // P and dS of this warp's rows into shared memory (0 where no key is seen)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = row0 + g + 8 * h;
                float pv[2], dsv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = k0 + 8 * j + 2 * tg + e;
                    float sv = p[j][2 * h + e];
                    if (causal && col > row) sv = -1e30f;
                    pv[e] = (live && row < t && col < t) ? expf(sv - lse_r[h]) : 0.f;
                    dsv[e] = pv[e] * (ds[j][2 * h + e] - delta_r[h]);
                }
                const int off = (r0 + g + 8 * h) * PS + 8 * j + 2 * tg;
                *reinterpret_cast<float2*>(pt + off) = make_float2(pv[0], pv[1]);
                *reinterpret_cast<float2*>(dst + off) = make_float2(dsv[0], dsv[1]);
            }
        // the block's columns, a chunk at a time: q's at a stage's start,
        // dO's after it; dV += P^T dO, dK += dS^T (q * scale)
        load_rows<BM, CS>(ring, q + base, q0, t, d, c0 * CH, CH / 4);
        load_rows<BM, CS>(ring + A_TILE, dout + base, q0, t, d, c0 * CH, CH / 4);
        cp_async_commit();
#pragma unroll
        for (int c = 0; c < MAX_NC; ++c) {
            if (c >= nc) break;
            float* st = ring + (c & 1) * STAGE;
            if (c + 1 < nc) {
                float* next = ring + ((c + 1) & 1) * STAGE;
                load_rows<BM, CS>(next, q + base, q0, t, d, (c0 + c + 1) * CH, CH / 4);
                load_rows<BM, CS>(next + A_TILE, dout + base, q0, t, d, (c0 + c + 1) * CH,
                                  CH / 4);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();                       // the chunk, P and dS are in shared memory
            if (takes_dv) accumulate_t(acc[c], pt, kr, st + A_TILE, 1.f, g, tg);
            else accumulate_t(acc[c], dst, kr, st, scale, g, tg);
            __syncthreads();   // every warp is done with this stage before it is refilled
        }
    }
    store_cols((takes_dv ? dv : dk) + base, acc, k0 + kr, t, d, c0, nc, 1.f, g, tg);
}

// ------------------------------------------------------------- launches

bool takes(int d) { return d >= 320 && d <= 2048 && d % CH == 0; }

dim3 grid(int rows, int tile, int bh, int d) {
    const int n = d / CH;
    return dim3((rows + tile - 1) / tile, bh, (n + MAX_NC - 1) / MAX_NC);
}

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

extern "C" int zoo_flash_attention_dq_wide(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse, const float* delta,
                                           float* dq, int bh, int t, int d,
                                           float scale, int causal, void* stream) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    cudaError_t err = smem(flash_dq_wide_kernel, FWD_BYTES);
    if (err != cudaSuccess) return (int)err;
    flash_dq_wide_kernel<<<grid(t, BM, bh, d), NTHREADS, FWD_BYTES,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
        q, k, v, dout, lse, delta, dq, t, d, scale, causal);
    return (int)cudaGetLastError();
}

extern "C" int zoo_flash_attention_dkv_wide(const float* q, const float* k,
                                            const float* v, const float* dout,
                                            const float* lse, const float* delta,
                                            float* dk, float* dv, int bh, int t,
                                            int d, float scale, int causal,
                                            void* stream) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    cudaError_t err = smem(flash_dkv_wide_kernel, DKV_BYTES);
    if (err != cudaSuccess) return (int)err;
    flash_dkv_wide_kernel<<<grid(t, BN, bh, d), NTHREADS, DKV_BYTES,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
        q, k, v, dout, lse, delta, dk, dv, t, d, scale, causal);
    return (int)cudaGetLastError();
}
