// Flash-attention backward on float32 inputs at head_dim 320 to 2048
// (multiples of 64) for Hopper (sm_90a): dQ and dK/dV, every product on the
// tensor cores in split TF32 (flash_tile.cuh: x = hi + lo, three
// mma.sync.m16n8k8 TF32 products a tile product, float32 accumulation).
// The forward at these widths is flash_attention_wide.cu; the backward at
// head_dim 64 to 256 is flash_attention_bwd.cu.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_dq_kernel
//           and ::_flash_dkv_kernel at these widths (launched from
//           _flash_vjp_bwd).
//
// Computes, per (batch*head) slice laid out (BH, T, D), with s = (q * scale)
// k^T (q scaled in float32 first; causal keys after the query at -1e30),
// p = exp(s - lse) from the forward's LSE, dP = dO V^T and ds = p * (dP -
// delta), delta = rowsum(dO * O):
//   dQ       dq = scale * sum_j ds_ij k_j;
//   dK/dV    dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij (scale * q_i).
//
// What bounds them on the H100: at (8, 2, 512, 384), BERT-base's width in
// two heads, dQ must do 6*B*H*T^2*D = 9.66 GFLOP and dK/dV 12.88, each
// taken as three TF32 products at 495 TFLOP/s: 0.059 and 0.078 ms, against
// ~0.02 ms to move their bytes.  They are bound by operations.
//
// Design.  One 16-row tile of dQ, dK or dV is D/2 registers a lane past
// head_dim 256, so a block owns at most 256 of the output's columns
// (MAX_NC chunks of 64): the grid's z splits them into z = ceil(D/256)
// column blocks as even as whole chunks allow (320 = 3 + 2 chunks, 768 =
// 3 x 4, 2048 = 8 x 4).  The z column blocks of a row tile form one thread
// block cluster (cluster dims (1, 1, z), launched with cudaLaunchKernelEx;
// z <= 8, the portable limit), and rank r of it owns the columns C_r.
// S and dP are needed over the whole of d, so:
//   - rank r takes the partial scores S_r = (q * scale)[:, C_r] K[:, C_r]^T
//     and dP_r = dO[:, C_r] V[:, C_r]^T over its own columns only
//     (partial_pair: a 64-row tile of q or dO, 4 warps of 16 rows, against
//     a 32-row tile of K or V, in 64-column chunks through a two-stage
//     cp.async ring, S's chunks and then dP's as one stream; a K or V
//     chunk split into hi (in place) and a lo plane as it lands, the q or
//     dO fragments split in registers); the 8-wide steps of its columns
//     are one accumulator chain, as the narrow kernels chain theirs over up
//     to 256 columns (PARTIAL_STEPS switches to the forward's per-step
//     sums, which on the H100 take 9-29% more time for a third to a fifth
//     of the chain's error; the chain stays within a sixth of the
//     tolerance);
//   - each warp puts its partials into its block's shared memory in the
//     m16n8 accumulator layout (a lane's four values of a tile as one
//     float4), and after a cluster barrier the ranks add all z partials of
//     every position in rank order 0 ... z-1 through distributed shared
//     memory (exchange): with fewer than SCATTER_FROM ranks every rank adds
//     every position itself (cluster_sum); with more, each rank adds its
//     share of the positions and, after a second barrier, every rank reads
//     each sum from its owner (cluster_reduce, cluster_gather), which moves
//     2 (z - 1) / z of the partials over the cluster in place of z - 1
//     times them.  Either way every rank holds the same S and dP, bit for
//     bit, so the same P and dS;
//   - so S and dP are taken once per (query tile, key tile) across the
//     cluster: each block reads only its own columns of q, K, V and dO, and
//     the work is the minimum (the first design of these kernels, where
//     every column block took the scores over all of d, did (2z + 1) / 3
//     times dQ's minimum and (z + 1) / 2 times dK/dV's).
//   The backward's s is not the forward's bit for bit (the forward takes
//   its partials in per-step sums, for LSE's tighter tolerance): both are
//   within float32 rounding of the exact s, which the tolerances against
//   the plain versions absorb.
//   dQ: grid (T/64, BH, z); a block owns 64 query rows and its columns;
//     for each 32-key tile S and dP (partials, then the cluster's sums),
//     P = exp(S - lse) and dS in registers, dQ += dS K[:, its columns]
//     (K's columns of the tile land plain beside the ring and are split as
//     read; flash_tile.cuh's accumulate).
//   dK/dV: grid (T/32, BH, z); a block owns 32 keys and its columns of dK
//     and dV and loops over 64-row q tiles: S and dP as dQ takes them
//     (query rows a warp), P and dS into shared memory split into hi and
//     lo parts as they are written, then its columns of q and dO through
//     the ring a chunk at a time: warps 0-1 add P^T dO to dV and warps 2-3
//     dS^T (q*scale) to dK, each for all 32 keys and half of each chunk's
//     columns, with P^T and dS^T read transposed from shared memory as A
//     operands and each B fragment of q or dO (split as read) feeding both
//     16-key tiles.  The columns of q and dO are read twice a q tile, for
//     the partials and for the products: the ring, P and dS with their lo
//     parts and the partials leave no room to keep them at two blocks an
//     SM.
// The cluster's barriers, the exchange and the cluster launch are
// flash_wide_cluster.cuh's, which the forward shares.  A step puts the
// partials, then arrive + wait (every rank's are in place), reads (after a
// scatter's second arrive + wait), then arrives as done reading.  dQ keeps its partials in the ring, so its wait on that last phase comes
// before the next tile's partials and overlaps the products, and it waits
// once more before it exits, so no rank leaves while another may still read
// its shared memory; dK/dV waits right away, since P's and dS's lo parts go
// where its partials were.  Every rank of a cluster runs the same tiles
// (the causal bounds depend on the row or key tile, not the columns) and
// reaches every barrier; a warp whose rows see none of a tile's keys skips
// its products and its reads, never a barrier.
// Shared memory: dQ 102,912 bytes (the ring 69,632, K's columns 33,280; the
// partials in the ring), dK/dV 106,496 (the ring, P and dS 18,432, their lo
// parts 18,432, where the partials, 16,384, go first): two blocks an SM.
// Registers (ptxas, no spill): dQ 245 (z < SCATTER_FROM) and 255, dK/dV 255
// and 255.  No output element is written by two blocks and nothing is
// accumulated with atomics, and the ranks' partials are added in a fixed
// order: two launches are bit-identical.  Rows and keys past T are
// zero-filled by the copies, get probability 0, and are not written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wide_cluster.cuh"

namespace {

using namespace flash_wide;

constexpr int PS = BN + 4;              // padded row stride of a P or dS tile
constexpr int DQ_BYTES = (RING + BN * OS) * (int)sizeof(float);
constexpr int DKV_BYTES = (RING + 4 * BM * PS) * (int)sizeof(float);
// the partial scores take their 64-column chunks as one accumulator chain
// (true: each 8-wide step's three products summed from zero, then added)
constexpr bool PARTIAL_STEPS = false;
// 8-wide steps of a chunk of the partial scores unrolled: all of them in dQ,
// two in dK/dV (the fastest of 1, 2 and 8 for each on the H100; none spills)
constexpr int DQ_UNROLL = 8;
constexpr int DKV_UNROLL = 2;
// a launch takes the exchange's scatter (flash_wide_cluster.cuh) for
// clusters of SCATTER_FROM ranks or more: on the H100 the second barrier
// costs more than the reads it saves at 2 and 3 ranks, and less at 8
constexpr int SCATTER_FROM = 4;
static_assert(2 * BM * CS <= STAGE, "a stage holds a chunk of q and of dO");
static_assert(2 * PART <= RING, "dQ keeps the partials in the ring");
static_assert(2 * PART <= 2 * BM * PS, "dK/dV keeps them where P's and dS's lo parts go");
static_assert(DKV_BYTES <= 232448 / 2 - 1024, "two blocks an SM on the H100");

// The partial scores of this warp's 16 rows (ra of a 64-row tile) over the
// chunks [c0, c0 + nc) of d, in m16n8 accumulators: p = (q[a0 : a0+64] *
// scale) . K[b0 : b0+32]^T and ds = dO[a0 : a0+64] . V[b0 : b0+32]^T.  The
// 2 nc chunk pairs (q and K, then dO and V) stream through the two-stage
// ring as one sequence, so dP's first chunk lands while S's last is taken.
// Collective: every thread of the block calls it (it loads and waits);
// warps not `live` skip the products.  It waits for every cp.async group
// this thread committed before it, and leaves the ring free.
template <int UNROLL>
__device__ __forceinline__ void partial_pair(float p[NJ][4], float ds[NJ][4], float* ring,
                                             const float* q, const float* k, const float* dout,
                                             const float* v, int a0, int b0, int t, int d,
                                             int c0, int nc, float scale, bool live, int ra,
                                             int g, int tg) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
    const int n = 2 * nc;
    auto load = [&](int i) {
        float* st = ring + (i & 1) * STAGE;
        const bool s = i < nc;
        const int col = (c0 + (s ? i : i - nc)) * CH;
        load_rows<BM, CS>(st, s ? q : dout, a0, t, d, col, CH / 4);
        load_rows<BN, CS>(st + A_TILE, s ? k : v, b0, t, d, col, CH / 4);
        cp_async_commit();
    };
    load(0);
    for (int i = 0; i < n; ++i) {
        float* st = ring + (i & 1) * STAGE;
        if (i + 1 < n) {
            load(i + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        split_b(st + A_TILE, st + A_TILE + B_TILE);
        __syncthreads();
        if (live) {
            const float* bh = st + A_TILE;
            if (i < nc)
                dots_chunk<UNROLL, PARTIAL_STEPS>(p, st, ra, bh, bh + B_TILE, scale, g, tg);
            else
                dots_chunk<UNROLL, PARTIAL_STEPS>(ds, st, ra, bh, bh + B_TILE, 1.f, g, tg);
        }
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
}

// ------------------------------------------------------------- helpers

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

// ------------------------------------------------------------------ dQ

template <bool SCATTER>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int t, int d, float scale, int causal) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4); // also the partials, between tiles
    float* kt_cols = ring + RING;                  // K's columns of a key tile, plain

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 16 * warp;
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BM;
    const int row0 = q0 + r0;                      // this warp's first row
    const size_t base = (size_t)bh * t * d;
    const int nz = gridDim.z;
    int c0, nc;
    my_chunks(d, c0, nc);

    int n_k = (t + BN - 1) / BN;
    if (causal) {
        const int last = (q0 + BM + BN - 1) / BN;  // tiles any row of this block sees
        n_k = n_k < last ? n_k : last;
    }

    float acc[MAX_NC][CH / 8][4];
    zero_acc(acc);

    for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * BN;
        load_rows<BN, OS>(kt_cols, k + base, k0, t, d, c0 * CH, nc * CH / 4);
        cp_async_commit();
        // causal: a warp whose rows all lie above this tile's keys skips it
        const bool live = row0 < t && !(causal && k0 > row0 + 15);
        // every rank is done reading the partials the last tile left in the ring
        if (kt > 0) cluster_wait();
        float p[NJ][4], ds[NJ][4];
        partial_pair<DQ_UNROLL>(p, ds, ring, q + base, k + base, dout + base, v + base, q0,
                                k0, t, d, c0, nc, scale, live, r0, g, tg);
        // (loaded each tile, after the partials: fewer registers live there)
        float lse_r[2], delta_r[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + g + 8 * h;
            lse_r[h] = row < t ? lse[(size_t)bh * t + row] : 0.f;
            delta_r[h] = row < t ? delta[(size_t)bh * t + row] : 0.f;
        }
        exchange<2, SCATTER>(p, ds, ring, nz, live);
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
    cluster_wait();        // no rank reads this block's shared memory any more
    store_cols(dq + base, acc, row0, t, d, c0, nc, scale, g, tg);
}

// ---------------------------------------------------------------- dK/dV

// acc[m][n] += w[:, 16m : 16m+16]^T . (x[:, xc+8n : xc+8n+8] * mul) summed
// over the BM rows of w and x, for the block's two 16-key tiles m and the
// four 8-column tiles n of this warp's half (xc) of a chunk: w a (BM x BN)
// tile of P or dS in query-row layout, split as it was written (hi part in
// wh, lo in wl; its rows the k dimension, read transposed as the A
// operand), x a plain (BM x 64) chunk tile of the block's columns, split
// as read, each B fragment feeding both key tiles.  k-slots t and t+4 of a
// step are rows 2t and 2t+1, as flash_tile.cuh's accumulate takes them.
__device__ __forceinline__ void accumulate_t(float acc[2][CH / 16][4], const float* wh,
                                             const float* wl, const float* x, int xc,
                                             float mul, int g, int tg) {
#pragma unroll
    for (int kk = 0; kk < BM / 8; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            const int o = (8 * kk + 2 * tg) * PS + 16 * m + g;
            const int offs[4] = {o, o + 8, o + PS, o + PS + 8};  // keys g, g+8; k-slots t, t+4
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ah[m][i] = __float_as_uint(wh[offs[i]]);
                al[m][i] = __float_as_uint(wl[offs[i]]);
            }
        }
        const int o = (8 * kk + 2 * tg) * CS + xc + g;
#pragma unroll
        for (int n = 0; n < CH / 16; ++n) {
            uint32_t h0, l0, h1, l1;
            split(x[o + 8 * n] * mul, h0, l0);
            split(x[o + CS + 8 * n] * mul, h1, l1);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                mma(acc[m][n], al[m], __uint_as_float(h0), __uint_as_float(h1));
                mma(acc[m][n], ah[m], __uint_as_float(l0), __uint_as_float(l1));
                mma(acc[m][n], ah[m], __uint_as_float(h0), __uint_as_float(h1));
            }
        }
    }
}

// The block's keys k0 + 16m + g (+8) of an accumulator over this warp's
// half (xc) of each of the block's chunks.
__device__ __forceinline__ void store_keys(float* dst, const float acc[MAX_NC][2][CH / 16][4],
                                           int k0, int t, int d, int c0, int nc, int xc,
                                           int g, int tg) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = k0 + 16 * m + g + 8 * h;
            if (row >= t) continue;
            float* drow = dst + (size_t)row * d + c0 * CH + xc + 2 * tg;
#pragma unroll
            for (int c = 0; c < MAX_NC; ++c) {
                if (c >= nc) break;
#pragma unroll
                for (int n = 0; n < CH / 16; ++n)
                    *reinterpret_cast<float2*>(drow + c * CH + 8 * n) =
                        make_float2(acc[c][m][n][2 * h], acc[c][m][n][2 * h + 1]);
            }
        }
}

template <bool SCATTER>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int t, int d,
                      float scale, int causal) {
    extern __shared__ float4 smem4[];
    // the ring: the partial scores' chunks, then the block's columns of q
    // and dO (a q tile's 64 rows of each, one 64-column chunk a stage)
    float* ring = reinterpret_cast<float*>(smem4);
    float* pt = ring + RING;                       // P of the q tile against the block's keys, hi
    float* dst = pt + BM * PS;                     // dS, the same
    float* pt_lo = dst + BM * PS;                  // their lo parts; the partials before them
    float* dst_lo = pt_lo + BM * PS;
    float* part = pt_lo;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 16 * warp;                      // this warp's q rows in a q tile
    const bool takes_dv = warp < 2;                // dV of the block's keys; else dK
    const int xc = 32 * (warp & 1);                // the half of each chunk it takes
    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * BN;                // the block's first key
    const size_t base = (size_t)bh * t * d;
    const float* lse_bh = lse + (size_t)bh * t;
    const float* delta_bh = delta + (size_t)bh * t;
    const int nz = gridDim.z;
    int c0, nc;
    my_chunks(d, c0, nc);

    const int n_q = (t + BM - 1) / BM;
    // causal: q tiles whose last row lies above the block's first key see
    // none of its keys
    const int qt0 = causal ? k0 / BM : 0;

    float acc[MAX_NC][2][CH / 16][4];              // dV in warps 0-1, dK in 2-3
#pragma unroll
    for (int c = 0; c < MAX_NC; ++c)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < CH / 16; ++n)
                acc[c][m][n][0] = acc[c][m][n][1] = acc[c][m][n][2] = acc[c][m][n][3] = 0.f;

    for (int qt = qt0; qt < n_q; ++qt) {
        const int q0 = qt * BM;
        const int row0 = q0 + r0;                  // this warp's first q row
        // causal: a warp whose rows all lie above the block's keys sees none
        const bool live = row0 < t && !(causal && k0 > row0 + 15);
        float p[NJ][4], ds[NJ][4];
        partial_pair<DKV_UNROLL>(p, ds, ring, q + base, k + base, dout + base, v + base, q0,
                                 k0, t, d, c0, nc, scale, live, r0, g, tg);
        // (loaded here, not before the partials: fewer registers live there)
        float lse_r[2], delta_r[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + g + 8 * h;
            lse_r[h] = row < t ? lse_bh[row] : 0.f;
            delta_r[h] = row < t ? delta_bh[row] : 0.f;
        }
        exchange<2, SCATTER>(p, ds, part, nz, live);
        cluster_wait();    // every rank is done reading the partials: their room is free
        // P and dS of this warp's rows into shared memory, split (0 where no
        // key is seen)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = row0 + g + 8 * h;
                uint32_t ph[2], pl[2], dh[2], dl[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = k0 + 8 * j + 2 * tg + e;
                    float sv = p[j][2 * h + e];
                    if (causal && col > row) sv = -1e30f;
                    const float pv = (live && row < t && col < t) ? expf(sv - lse_r[h]) : 0.f;
                    split(pv, ph[e], pl[e]);
                    split(pv * (ds[j][2 * h + e] - delta_r[h]), dh[e], dl[e]);
                }
                const int off = (r0 + g + 8 * h) * PS + 8 * j + 2 * tg;
                *reinterpret_cast<uint2*>(pt + off) = make_uint2(ph[0], ph[1]);
                *reinterpret_cast<uint2*>(pt_lo + off) = make_uint2(pl[0], pl[1]);
                *reinterpret_cast<uint2*>(dst + off) = make_uint2(dh[0], dh[1]);
                *reinterpret_cast<uint2*>(dst_lo + off) = make_uint2(dl[0], dl[1]);
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
            if (takes_dv) accumulate_t(acc[c], pt, pt_lo, st + A_TILE, xc, 1.f, g, tg);
            else accumulate_t(acc[c], dst, dst_lo, st, xc, scale, g, tg);
            __syncthreads();   // every warp is done with this stage before it is refilled
        }
    }
    store_keys(takes_dv ? dv + base : dk + base, acc, k0, t, d, c0, nc, xc, g, tg);
}

// ------------------------------------------------------------- launches

}  // namespace

extern "C" int zoo_flash_attention_dq_wide(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse, const float* delta,
                                           float* dq, int bh, int t, int d,
                                           float scale, int causal, void* stream) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    const dim3 g = grid(t, BM, bh, d);
    return (int)launch((int)g.z >= SCATTER_FROM ? flash_dq_wide_kernel<true>
                                                : flash_dq_wide_kernel<false>,
                       g, DQ_BYTES, stream, q, k, v, dout, lse, delta, dq, t, d, scale, causal);
}

extern "C" int zoo_flash_attention_dkv_wide(const float* q, const float* k,
                                            const float* v, const float* dout,
                                            const float* lse, const float* delta,
                                            float* dk, float* dv, int bh, int t,
                                            int d, float scale, int causal,
                                            void* stream) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    const dim3 g = grid(t, BN, bh, d);
    return (int)launch((int)g.z >= SCATTER_FROM ? flash_dkv_wide_kernel<true>
                                                : flash_dkv_wide_kernel<false>,
                       g, DKV_BYTES, stream, q, k, v, dout, lse, delta, dk, dv, t, d, scale,
                       causal);
}

// How many clusters of the dQ (dkv = 0) or dK/dV (dkv = 1) kernel's blocks
// at head_dim d (ceil(d / 256) blocks a cluster, the instance a launch at
// d takes) the card can hold at once (cudaOccupancyMaxActiveClusters),
// into *clusters.
extern "C" int zoo_flash_wide_bwd_max_clusters(int dkv, int d, int* clusters) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    const int z = (int)grid(1, 1, 1, d).z;
    if (dkv)
        return (int)max_clusters(z >= SCATTER_FROM ? flash_dkv_wide_kernel<true>
                                                   : flash_dkv_wide_kernel<false>,
                                 DKV_BYTES, z, clusters);
    return (int)max_clusters(z >= SCATTER_FROM ? flash_dq_wide_kernel<true>
                                               : flash_dq_wide_kernel<false>,
                             DQ_BYTES, z, clusters);
}
