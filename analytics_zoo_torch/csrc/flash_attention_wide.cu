// Flash-attention forward on float32 inputs at head_dim 320 to 2048
// (multiples of 64) for Hopper (sm_90a), every product on the tensor cores
// in split TF32 (flash_tile.cuh: x = hi + lo, three mma.sync.m16n8k8 TF32
// products a tile product, float32 accumulation).  flash_attention_fwd.cu
// takes head_dim 64 to 256, where one 16-row warp tile of O fits in
// registers.  The backward at these widths (dQ and dK/dV) is
// flash_attention_wide_bwd.cu, a cluster design on the same shared code.
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
// flash_attention_fwd.cu's Cfg<256>): the grid's z splits them into z =
// ceil(D/256) column blocks as even as whole chunks allow (320 = 3 + 2
// chunks, 768 = 3 x 4, 2048 = 8 x 4), and the z column blocks of a row
// tile form one thread block cluster (cluster dims (1, 1, z); rank r owns
// the columns C_r; flash_wide_cluster.cuh).  S is needed over the whole of
// d, so for each 32-key tile:
//   - rank r takes the partial scores S_r = (q * scale)[:, C_r] K[:,
//     C_r]^T over its own columns only (partial_scores: a 64-row tile of q,
//     4 warps of 16 rows, against the key tile, in 64-column chunks through
//     a two-stage cp.async ring; a K chunk split into hi (in place) and a
//     lo plane as it lands, the q fragments split in registers after the
//     multiply by scale, in float32 as the reference takes it).  Its 8-wide
//     steps are summed as SCORE_STEPS says: each step's three products from
//     zero, the step's sum then added in float32 (one chain a partial, the
//     backward's order, is 7-11% faster on the H100 but took LSE to 0.72 of
//     its tolerance at 2048, causal; flash_wide_tile.cuh's dots_chunk says
//     why the sum drifts);
//   - each warp puts its partial into the block's shared memory (in the
//     ring, free between the tiles' chunks), and after a cluster barrier
//     the ranks add the z partials in rank order 0 ... z-1 through
//     distributed shared memory (exchange: every rank adds every position
//     itself below FWD_SCATTER_FROM ranks; from there each rank adds its
//     share and gathers the rest from their owners after a second barrier:
//     on the H100 all-read wins at 2 and 3 ranks, the two tie at 4, the
//     scatter wins from 5).  Every rank then holds the same S, bit for
//     bit, so it reaches the same m and l;
//   - every rank runs the online softmax in registers and adds O += P V[:,
//     C_r] from P's accumulator registers (flash_tile.cuh's accumulate; V's
//     columns of the tile land plain beside the ring and are split as
//     read).  Rank 0 writes LSE; every rank writes its own columns of O.
// So S is taken once per (query tile, key tile) across the cluster: each
// block reads only its own columns of q, K and V, and the work is the
// minimum.  (This kernel's first design, where every column block took S
// over all of d, did (z + 1) / 2 times it: 1.5, 2 and 4.5 times at 384,
// 768 and 2048.)  The dQ kernel takes its s by the same partials in one
// accumulator chain each, so the two are not the same s bit for bit when
// SCORE_STEPS is true; both are within float32 rounding of it.
// Cluster barriers: the partials stay in the ring, so a tile's wait on the
// last exchange's "done reading" comes before its partial scores refill
// the ring, and the block waits once more before it exits, so no rank
// leaves while another may still read its shared memory.  Every rank of a
// cluster runs the same key tiles (the causal bound depends on the row
// tile, not the columns) and reaches every barrier; a warp whose rows see
// none of a tile's keys skips its products and its reads, never a barrier.
// Shared memory: the ring 69,632 bytes (the partial, 8,192, in it between
// tiles), V's columns 33,280: 102,912, two blocks an SM.  Registers
// (ptxas): 247 (all-read) and 254 (scatter), no spill.  (A block of 128
// query rows in 8 warps with q's columns resident, one block an SM, was
// 7-9% faster at 384 but 8% slower at 768, where its 16-key tiles double
// the exchanges, and 23% slower at 2048, where clusters of 8 whole SMs
// leave fewer resident.)  No output element is written
// by two blocks, nothing is accumulated with atomics, and the partials are
// added in a fixed order: two launches are bit-identical.  Rows and keys
// past T are zero-filled by the copies, keys past T get s = -inf and
// probability 0, rows past T are not written; causal blocks stop at the
// last key tile any of their rows sees.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wide_cluster.cuh"

namespace {

using namespace flash_wide;

constexpr int FWD_BYTES = (RING + BN * OS) * (int)sizeof(float);
static_assert(FWD_BYTES <= 232448 / 2, "two blocks an SM on the H100");
static_assert(PART <= RING, "the partial stays in the ring between tiles");
// the 8-wide steps of the partial scores: each step's three products
// summed from zero, then added (true), or one accumulator chain (false)
constexpr bool SCORE_STEPS = true;
// 8-wide steps of a chunk of the partial scores unrolled: one (faster on
// the H100 than two or eight, and the only one whose scatter instance does
// not spill)
constexpr int FWD_UNROLL = 1;
// a launch takes the exchange's scatter for clusters of FWD_SCATTER_FROM
// ranks or more
constexpr int FWD_SCATTER_FROM = 4;

// x = (a[a0 : a0+64, C] * mul) . b[b0 : b0+32, C]^T over the chunks C =
// [c0, c0 + nc) of d, this warp's 16 rows (ra of the a tile) in m16n8
// accumulators.  Collective: every thread of the block calls it (it loads
// and waits); warps not `live` skip the products.  It waits for every
// cp.async group this thread committed before it, and leaves the ring
// free.
__device__ __forceinline__ void partial_scores(float x[NJ][4], float* ring, const float* a,
                                               int a0, const float* b, int b0, int t, int d,
                                               int c0, int nc, float mul, bool live, int ra,
                                               int g, int tg) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
    auto load = [&](int c) {
        float* st = ring + (c & 1) * STAGE;
        load_rows<BM, CS>(st, a, a0, t, d, (c0 + c) * CH, CH / 4);
        load_rows<BN, CS>(st + A_TILE, b, b0, t, d, (c0 + c) * CH, CH / 4);
        cp_async_commit();
    };
    load(0);
    for (int c = 0; c < nc; ++c) {
        float* st = ring + (c & 1) * STAGE;
        if (c + 1 < nc) {
            load(c + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        split_b(st + A_TILE, st + A_TILE + B_TILE);
        __syncthreads();
        if (live)
            dots_chunk<FWD_UNROLL, SCORE_STEPS>(x, st, ra, st + A_TILE, st + A_TILE + B_TILE, mul,
                                                g, tg);
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
}

// ------------------------------------------------------------- forward

template <bool SCATTER>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int t, int d, float scale, int causal) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4); // also the partial, between tiles
    float* vt = ring + RING;                       // V's columns of a key tile, plain

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
        // every rank is done reading the partials the last tile left in the ring
        if (kt > 0) cluster_wait();
        float p[NJ][4];
        partial_scores(p, ring, q + base, q0, k + base, k0, t, d, c0, nc, scale, live, r0, g,
                       tg);
        exchange<1, SCATTER>(p, nullptr, ring, nz, live);
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
    cluster_wait();        // no rank reads this block's shared memory any more

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

}  // namespace

extern "C" int zoo_flash_attention_fwd_wide(const float* q, const float* k,
                                            const float* v, float* o, float* lse,
                                            int bh, int t, int d, float scale,
                                            int causal, void* stream) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    const dim3 g = grid(t, BM, bh, d);
    return (int)launch((int)g.z >= FWD_SCATTER_FROM ? flash_fwd_wide_kernel<true>
                                                    : flash_fwd_wide_kernel<false>,
                       g, FWD_BYTES, stream, q, k, v, o, lse, t, d, scale, causal);
}

// How many clusters of the forward's blocks at head_dim d (ceil(d / 256)
// blocks a cluster, the instance a launch at d takes) the card can hold at
// once (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int zoo_flash_wide_fwd_max_clusters(int d, int* clusters) {
    if (!takes(d)) return (int)cudaErrorInvalidValue;
    const int z = (int)grid(1, 1, 1, d).z;
    return (int)max_clusters(z >= FWD_SCATTER_FROM ? flash_fwd_wide_kernel<true>
                                                   : flash_fwd_wide_kernel<false>,
                             FWD_BYTES, z, clusters);
}
