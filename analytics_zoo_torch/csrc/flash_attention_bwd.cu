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
//   D=64: BM=128 (8 warps), BN=64; the dK and dV accumulators (32
//   registers each) fit beside P and dS.
//   D=128, 192 and 256 (BM=64): the two accumulators take 128, 192 and
//   256 registers a lane, at or near the 255 a thread may have before S^T,
//   dP^T, P^T and dS^T (at 128 one warp's dK/dV spilled 120 bytes).  So
//   there dK/dV splits its work across two warps a 16-key group (SPLIT):
//   the dV warp takes S^T, forms P^T, puts it in shared memory in its
//   fragment layout and adds P^T dO to dV; the dK warp takes dP^T, reads
//   the partner's P^T, forms dS^T and adds dS^T (q*scale) to dK.  Each
//   holds one accumulator (64, 96 or 128 registers) and does half the
//   products, with no work repeated: 8 warps a block.  dQ splits the same
//   way: the P warp takes S and P, the dP warp dP, both put their tile in
//   shared memory, form the same dS and add dS K to their half of dQ's
//   columns.  Each output element takes the products of the unsplit
//   kernels, in their order: the split and unsplit kernels give
//   bit-identical outputs at every width.  On the H100 the split kernels
//   take 0.92 (dQ) and 0.77 (dK/dV) of the unsplit ones' time at
//   (8, 6, 512, 128), and 1.10 and 1.07 at (8, 12, 512, 64), where the
//   unsplit ones stay.  A warp's S or dP is a row of NJ chains of
//   dependent mma (96 in a chain at D=256), so the time goes to their
//   latency: two warps a sub-partition, and BN=32 at D=128, 16 (two chains
//   a warp) at 192 and 256.  At D=256 that leaves no room for one lo
//   plane (BN=16 with all of them would take 232,960 bytes for dQ even
//   unsplit, over the 232,448 a block may have): dQ keeps V plain and
//   dK/dV keeps dO plain, and the warps that read them split their
//   fragments as they read them (flash_tile.cuh's RAW_B and RAW_X), to
//   the parts split_own would store.  Shared memory: dQ 185,344 bytes at
//   D=128, 183,808 at 192 and 224,512 at 256; dK/dV 177,664, 179,968 and
//   220,672.  Registers (ptxas): dQ 134, 148 and 189 a thread, dK/dV 246,
//   239 and 255 (12 bytes spilled at 256).
//   scripts/bench_flash.py --wide --diagnose times these against the
//   earlier designs (WIDE_VARIANTS).
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

// dQ's tiles: BM q rows a block, 16 a warp; BN-row K and V tiles streamed
template <int D_>
struct DqCfg {
    static constexpr int D = D_;
    static constexpr int BM = D == 64 ? 128 : 64;  // q rows a block owns
    // rows of each streamed K and V tile
    static constexpr int BN = D == 64 ? 64 : D == 128 ? 32 : 16;
    static constexpr bool SPLIT = D > 64;          // two warps a 16-row group
    // V split as it lands into a lo plane; else (no room) as it is read
    static constexpr bool V_LO = D != 256;
    static constexpr int NGROUPS = BM / 16;
    static constexpr int NWARPS = SPLIT ? 2 * NGROUPS : NGROUPS;
    static constexpr int NTHREADS = 32 * NWARPS;
    static constexpr int NJ = BN / 8;              // m16n8 tiles across a streamed tile
    static constexpr int S = D + 4;                // padded row stride, floats
    static constexpr int OWN = BM * S;             // floats in the block's own tile
    static constexpr int TILE = BN * S;            // floats in one streamed tile
    // own: q and dO; ring: two stages of K and V (split in place to their
    // hi parts, V only where V_LO); their lo planes; SPLIT: P and dP of
    // every group
    static constexpr int BYTES =
        (2 * OWN + (V_LO ? 6 : 5) * TILE + (SPLIT ? 2 * BM * BN : 0)) * (int)sizeof(float);
    static_assert(BYTES <= 232448, "a block's shared memory on the H100");
};

// accumulate() over half the columns of a tile config C, at C's stride:
// the split dQ's share of dQ
template <class C>
struct HalfCols {
    static constexpr int D = C::D / 2;
    static constexpr int S = C::S;
    static constexpr int NJ = C::NJ;
};

// dK/dV's tiles: BM key rows a block in groups of 16, BN-row q and dO
// tiles streamed; SPLIT: two warps a group, the dV and the dK warp
template <int D_>
struct DkvCfg {
    static constexpr int D = D_;
    static constexpr int BM = D == 64 ? 128 : 64;  // key rows a block owns
    // rows of each streamed q and dO tile
    static constexpr int BN = D == 64 ? 64 : D == 128 ? 32 : 16;
    static constexpr bool SPLIT = D > 64;          // two warps a 16-key group
    // dO split as it lands into a lo plane; else (no room) as it is read
    static constexpr bool DO_LO = D != 256;
    static constexpr int NGROUPS = BM / 16;
    static constexpr int NWARPS = SPLIT ? 2 * NGROUPS : NGROUPS;
    static constexpr int NTHREADS = 32 * NWARPS;
    static constexpr int NJ = BN / 8;
    static constexpr int S = D + 4;
    static constexpr int OWN = BM * S;
    static constexpr int TILE = BN * S;
    // own: K and V; ring: two stages of q and dO; their lo planes (dO's
    // where DO_LO); lse and delta (two stages of BN each); SPLIT: P^T of
    // every group (BM x BN)
    static constexpr int BYTES =
        (2 * OWN + (DO_LO ? 6 : 5) * TILE + 4 * BN + (SPLIT ? BM * BN : 0)) *
        (int)sizeof(float);
    static_assert(BYTES <= 232448, "a block's shared memory on the H100");
};

// W columns of 16 rows (W = D, or half of them where dQ is split) at row
// stride D
template <int D, int W = D>
__device__ __forceinline__ void store_rows(float* dst, const float acc[W / 8][4], int row0,
                                           int t, float mul, int g, int tg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        if (row >= t) continue;
#pragma unroll
        for (int n = 0; n < W / 8; ++n)
            *reinterpret_cast<float2*>(dst + (size_t)row * D + 8 * n + 2 * tg) =
                make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
}

// ------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::NTHREADS, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int t, float scale, int causal) {
    using C = DqCfg<D>;
    static_assert(!C::SPLIT && C::V_LO, "flash_dq_split_kernel takes the split widths");
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

// D=128, 192 and 256 (DqCfg::SPLIT): each 16-row group's work split between
// two warps.  The P warp takes S and P = exp(S - lse), the dP warp
// dP = dO V^T; each puts its tile in shared memory in its fragment layout,
// both form the same dS = P (dP - delta), and each adds dS K to its half
// of dQ's columns.  Each dQ element takes the products of flash_dq_kernel
// in their order.

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::NTHREADS, 1)
flash_dq_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, int t, float scale, int causal) {
    using C = DqCfg<D>;
    static_assert(C::SPLIT, "flash_dq_kernel takes the unsplit widths");
    constexpr int BM = C::BM, BN = C::BN, NJ = C::NJ;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);
    float* dos = qs + C::OWN;
    float* ring = dos + C::OWN;                    // stage s: K at 2s, V at 2s+1
    float* k_lo = ring + 4 * C::TILE;
    float* v_lo = C::V_LO ? k_lo + C::TILE : nullptr;
    // P, a float4 a lane and m16n8 tile
    float4* pbuf = reinterpret_cast<float4*>(k_lo + (C::V_LO ? 2 : 1) * C::TILE);
    float4* dpbuf = pbuf + C::NGROUPS * NJ * 32;               // dP, the same

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int group = warp % C::NGROUPS;           // this warp's 16 rows
    const bool takes_p = warp < C::NGROUPS;        // the group's P warp; else its dP warp
    const int c0 = takes_p ? 0 : D / 2;            // this warp's half of dQ's columns
    const int r0 = 16 * group;
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

    float acc[D / 16][4];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float4* p_g = pbuf + group * NJ * 32 + lane;   // this group's P and dP, this lane's
    float4* dp_g = dpbuf + group * NJ * 32 + lane;

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
        if (C::V_LO) split_own<C>(vs, v_lo, 1.f);
        __syncthreads();

        const int k0 = kt * BN;
        // causal: a group whose rows all lie above this tile's keys skips it
        const bool live = row0 < t && !(causal && k0 > row0 + 15);
        float x[NJ][4];
        if (live && takes_p) {
            dots<C>(x, qs, r0, ks, k_lo, g, tg);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = row0 + g + 8 * (e >> 1);
                    const int col = k0 + 8 * j + 2 * tg + (e & 1);
                    float sv = x[j][e];
                    if (causal && col > row) sv = -1e30f;
                    x[j][e] = (row < t && col < t) ? expf(sv - lse_r[e >> 1]) : 0.f;
                }
                p_g[32 * j] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
            }
        }
        if (live && !takes_p) {
            dots<C, !C::V_LO>(x, dos, r0, vs, v_lo, g, tg);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                dp_g[32 * j] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
        }
        __syncthreads();                           // P and dP are in shared memory
        if (live) {
            float ds[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float4 pp = p_g[32 * j], dp = dp_g[32 * j];
                ds[j][0] = pp.x * (dp.x - delta_r[0]);
                ds[j][1] = pp.y * (dp.y - delta_r[0]);
                ds[j][2] = pp.z * (dp.z - delta_r[1]);
                ds[j][3] = pp.w * (dp.w - delta_r[1]);
            }
            accumulate<HalfCols<C>>(acc, ds, ks + c0, k_lo + c0, g, tg);
        }
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
    store_rows<D, D / 2>(dq + base + c0, acc, row0, t, scale, g, tg);
}

// ---------------------------------------------------------------- dK/dV

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::NTHREADS, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int t,
                 float scale, int causal) {
    using C = DkvCfg<D>;
    static_assert(!C::SPLIT && C::DO_LO, "flash_dkv_split_kernel takes the split widths");
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

// D=128, 192 and 256 (DkvCfg::SPLIT): the same work, each 16-key group's split
// between a dV warp (S^T, P^T into shared memory, dV += P^T dO) and a dK
// warp (dP^T, the partner's P^T, dS^T, dK += dS^T (q*scale)); the
// products of each and their order are those of flash_dkv_kernel.

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::NTHREADS, 1)
flash_dkv_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int t,
                       float scale, int causal) {
    using C = DkvCfg<D>;
    static_assert(C::SPLIT, "flash_dkv_kernel takes the unsplit widths");
    constexpr int BM = C::BM, BN = C::BN, NJ = C::NJ;
    extern __shared__ float4 smem4[];
    float* ks = reinterpret_cast<float*>(smem4);
    float* vs = ks + C::OWN;
    float* ring = vs + C::OWN;                     // stage s: q at 2s, dO at 2s+1
    float* q_lo = ring + 4 * C::TILE;
    float* do_lo = C::DO_LO ? q_lo + C::TILE : nullptr;
    // stage s: lse at 2s, delta at 2s+1 (BN each)
    float* rows = q_lo + (C::DO_LO ? 2 : 1) * C::TILE;
    float4* pt = reinterpret_cast<float4*>(rows + 4 * BN);  // P^T, a float4 a lane and m16n8 tile

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int group = warp % C::NGROUPS;           // this warp's 16 key rows
    const bool takes_dv = warp < C::NGROUPS;       // the group's dV warp; else its dK warp
    const int r0 = 16 * group;
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

    // dV in the dV warp, dK in the dK warp
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
        if (C::DO_LO) split_own<C>(dos, do_lo, 1.f);
        __syncthreads();

        const int q0 = qt * BN;
        // causal: a group whose keys all lie past this tile's queries skips it
        const bool live = row0 < t && !(causal && row0 > q0 + BN - 1);
        float p[NJ][4], ds[NJ][4];
        float4* pt_g = pt + group * NJ * 32 + lane;   // this group's P^T, this lane's
        if (live && takes_dv) {
            // this group's key rows row0 + g (+8) against queries 8j + 2tg
            // (+1): P^T = exp(S^T - lse) from S^T = K (q*scale)^T
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
                pt_g[32 * j] = make_float4(p[j][0], p[j][1], p[j][2], p[j][3]);
            }
        }
        if (live && !takes_dv) dots<C, !C::DO_LO>(ds, vs, r0, dos, do_lo, g, tg);  // dP^T = V dO^T
        __syncthreads();                           // P^T is in shared memory
        if (live && takes_dv) accumulate<C, !C::DO_LO>(acc, p, dos, do_lo, g, tg);
        if (live && !takes_dv) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float4 x = pt_g[32 * j];
                const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tg);
                ds[j][0] = x.x * (ds[j][0] - d2.x);
                ds[j][1] = x.y * (ds[j][1] - d2.y);
                ds[j][2] = x.z * (ds[j][2] - d2.x);
                ds[j][3] = x.w * (ds[j][3] - d2.y);
            }
            accumulate<C>(acc, ds, qs, q_lo, g, tg);
        }
        __syncthreads();   // every warp is done with this stage before it is refilled
    }
    store_rows<D>((takes_dv ? dv : dk) + base, acc, row0, t, 1.f, g, tg);
}

// the dQ and dK/dV kernels of head_dim D (only those are instantiated)
template <int D>
auto dq_kernel() {
    if constexpr (DqCfg<D>::SPLIT) return flash_dq_split_kernel<D>;
    else return flash_dq_kernel<D>;
}

template <int D>
auto dkv_kernel() {
    if constexpr (DkvCfg<D>::SPLIT) return flash_dkv_split_kernel<D>;
    else return flash_dkv_kernel<D>;
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int bh, int t, float scale, int causal,
                      cudaStream_t stream) {
    using C = DqCfg<D>;
    const auto kernel = dq_kernel<D>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((t + C::BM - 1) / C::BM, bh);
    kernel<<<grid, C::NTHREADS, C::BYTES, stream>>>(
        q, k, v, dout, lse, delta, dq, t, scale, causal);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int t, float scale,
                       int causal, cudaStream_t stream) {
    using C = DkvCfg<D>;
    const auto kernel = dkv_kernel<D>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((t + C::BM - 1) / C::BM, bh);
    kernel<<<grid, C::NTHREADS, C::BYTES, stream>>>(
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
        case 192:
            return (int)launch_dq<192>(q, k, v, dout, lse, delta, dq, bh, t, scale,
                                       causal, s);
        case 256:
            return (int)launch_dq<256>(q, k, v, dout, lse, delta, dq, bh, t, scale,
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
        case 192:
            return (int)launch_dkv<192>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                        scale, causal, s);
        case 256:
            return (int)launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                        scale, causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
