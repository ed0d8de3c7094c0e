// Flash-attention backward on bfloat16 inputs for Hopper (sm_90a): dQ
// (zoo_flash_attention_dq_bf16) and dK/dV (zoo_flash_attention_dkv_bf16),
// on wgmma, TMA and mbarriers (wgmma_tile.cuh).  The float32 backward
// stays in flash_attention_bwd.cu.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_dq_kernel
//           and ::_flash_dkv_kernel (launched from _flash_vjp_bwd) on
//           bf16 q, k, v.
//
// What they compute, per (query row i, key row j) of one (batch*head)
// slice laid out (BH, T, D); q, k, v, dO bf16, lse and delta float32:
//   qs_i  = bf16(q_i * bf16(scale))     (the reference's q * scale in bf16:
//                                         the scale rounded, the exact
//                                         product rounded once)
//   s_ij  = qs_i . k_j                   (bf16 products, float32 sums;
//                                         causal: -1e30 where j > i)
//   p_ij  = exp(s_ij - lse_i),  dp_ij = do_i . v_j,
//   ds_ij = p_ij * (dp_ij - delta_i)     (float32, never rounded)
//   dq_i  = scale * sum_j ds_ij k_j,  dk_j = sum_i ds_ij qs_i,
//   dv_j  = sum_i p_ij do_i              (float32 sums, one bf16 rounding)
// dQ, dK and dV have one float32 operand (dS or P).  It is split into
// three bf16 parts, x = hi + mid + lo (flash_tile.cuh's bf16_parts; the
// residue is below 2^-24 of |x|), and the product taken as three bf16
// products, the smallest part first: float32's accuracy at the bf16 rate.
// S is summed over d in the tensor core's order for wgmma, which need not
// be the bf16 forward's (mma.sync): P = exp(S - lse) may differ from the
// forward's by float32 rounding, within the tolerances that hold the
// kernels to their plain versions.
//
// What bounds them on the H100: at bench_attention's (4, 8, 4096, 128),
// causal, one T x T product of depth D is X = 2 * B*H * T^2/2 * D =
// 6.87e10 FLOP.  dQ takes S and dP as one bf16 pass each and dS K as
// three: 5X at 989 TFLOP/s, 0.347 ms; dK/dV takes S^T and dP^T, then
// P^T dO and dS^T qs as three each: 8X, 0.556 ms.  Their bytes (q, k, v,
// dO and the outputs, 33.5 MB each) take ~0.05 ms: bound by operations,
// at the tensor cores' bf16 rate, which only wgmma reaches.
//
// Design (the mma.sync kernels this replaces reached 0.24 and 0.28 of the
// bounds; every warp there read a streamed tile's B fragments for its own 16
// rows, 256 shared-memory bytes an m16n8k16):
//   - A block has three warpgroups: warpgroup 0 loads, warpgroups 1 and 2
//     take every product as wgmma m64nNk16, so the tensor core reads a B
//     operand once for 64 rows.  While one consumer takes exp and the
//     three-part split on the ALUs, the other keeps the tensor core busy.
//   - TMA loads the block's own tiles once (q, dO in dQ; K, V in dK/dV)
//     and streams 64-row tiles (K, V in dQ; q, dO in dK/dV) through a
//     ring of STAGES stages, each completed on a `full` mbarrier and
//     released on an `empty` one.  Rows past T land as zeros (3-D tensor
//     maps), and only the ragged last tile and the causal diagonal tile
//     are masked.
//   - S and dP (S^T and dP^T) take both operands K-major from shared
//     memory; P and dS go from their accumulators into the next product
//     as register A operands, three bf16 parts each; the bf16 operand of
//     dQ, dV and dK is the streamed tile read MN-major (transposed), the
//     same shared tile the S product read K-major.
//   - Registers: __launch_bounds__(384, 1) gives ptxas 168 a thread, and
//     it compiles every role within them (setmaxnreg then moves the
//     loader's unused registers to the consumers at run time: 24/240 in
//     dQ, 40/232 in dK/dV).  dQ's consumer fits: 64 dQ + 32 S + 32 dP, or
//     48 for dS's parts.  dK and dV of 64 keys at D = 128 would take 128
//     alone, and with S^T, dP^T and the parts ptxas spilled and
//     serialized the wgmmas.  So dK/dV splits by output: a block owns 64
//     keys; consumer 1 takes S^T, P^T and dV += P^T dO, and writes P^T
//     (float32, 16 KB a stage) to shared memory; consumer 2 takes dP^T,
//     waits for P^T on a `pready` mbarrier, forms dS^T and dK += dS^T qs.
//     Each holds one 64 x D accumulator, and the pair does the 8 passes
//     once, four each.
//   - q * scale: dQ rounds its own q tile once, each consumer warpgroup
//     its 64 rows, in shared memory.  dK/dV streams q: the loader
//     warpgroup rounds each q tile once as it lands, before it releases
//     the tile to the consumers, off their path.  Each of a slice's T/64
//     key blocks still rounds the q tiles it reads, as the mma.sync
//     design's did: the cost moved off the consumers, it did not shrink.
//     lse and delta, per query column there, are staged by the loader
//     beside the tile.
//   - Causal work is uneven: the grid runs (B*H, T/BM) with the block
//     row along y, so the blocks with the most tiles come first in
//     launch order (dQ: its last query rows; dK/dV: its first keys), and
//     the short ones fill the last wave.
//   - No atomics: each output row belongs to one warpgroup of one block,
//     so two launches give bit-identical outputs.
//   Shared memory at D = 128: dQ 163 KB (q, dO of 128 rows; three stages
//   of K, V), dK/dV 179 KB (K, V of 64 rows; three stages of q, dO, lse,
//   delta and P^T), alignment included.
//
// Head_dim 192 and 256.  A consumer's 64 x D float32 accumulator is 96 or
// 128 registers a thread; with S or dP (32) and dS's parts (48) beside it
// no role fits the 168 registers ptxas gives a thread of a 288- or
// 384-thread block (three warps share a register file).  A block of 256
// threads may take 255.
//   - dK/dV (flash_dkv_bf16_pair_kernel): two consumer warpgroups and no
//     loader warpgroup, one block a 64-key block, as at 128: consumer 0
//     takes S^T, P^T (into shared memory, `pready`; two buffers, released
//     on `pfree`) and dV += P^T dO; consumer 1 takes dP^T, dS^T and
//     dK += dS^T qs, and its thread 0 issues every TMA load after its own
//     products.  8 passes a key block, q and dO streamed once.  q *
//     scale: where the rounded scale is a power of two (head_dim 256's
//     1/16), bf16(q * scale) = q * scale, so both consumers read q as it
//     lands and S^T and dK take the scale (S^T before exp, dK at the
//     store), exactly; otherwise (192) consumer 1 rounds the next q tile
//     while its dP^T is on the tensor core and releases it on `full`.
//     Each consumer reads its tile's lse or delta from global memory.
//     Shared memory 230,512 / 230,488 bytes at 192 / 256: K, V; three /
//     two stages of q and dO; two P^T buffers of 16 KB.  It keeps every
//     sum of the design it replaced (two one-consumer blocks a key block):
//     dK and dV are bit-identical to it (q past bf16's normal range aside,
//     where the exact scale skips a rounding of q * scale the reference
//     takes).
//   - dQ (Cfg::NC = 1): the loader warpgroup and one consumer warpgroup,
//     256 threads, two stages, 64 query rows a block.  Two consumers a
//     64-row tile, each with half of dQ's columns and P and dP - delta
//     swapped between them, were slower (PERF.md).
//   dQ, dV and dK take their D columns as a 128- and a 64- or 128-column
//   wgmma on the same A registers (wgmma_rs).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

using flash_tile::bf16;
using flash_tile::bf16_parts;
using namespace wgmma_tile;

constexpr int PARTS = 3;  // bf16 parts of a float32 operand (smallest first)

template <int D_, bool DQ>
struct Cfg {
    static constexpr int D = D_;
    static constexpr int NC = DQ && D_ > 128 ? 1 : 2;   // consumer warpgroups (see above)
    static constexpr int BM = DQ ? 64 * NC : 64;   // rows a block owns: dQ 128 (64), dK/dV 64
    static constexpr int BN = 64;                  // rows of a streamed tile
    static constexpr int STAGES = NC == 2 ? 3 : 2;
    static constexpr int NTHREADS = 128 * (1 + NC);   // loader + consumer warpgroups
    static constexpr int NK = BN / 16;             // reduction steps over a streamed tile
    static constexpr int OWN = BM * D * 2;         // bytes of an own tile
    static constexpr int TILE = BN * D * 2;        // bytes of a streamed tile
    static constexpr int RING = 2 * OWN;           // stage s: two tiles at RING + 2s TILE
    static constexpr int ROWS = RING + STAGES * 2 * TILE;   // dK/dV, stage s: lse, delta
    static constexpr int PBUF = ROWS + STAGES * 2 * BN * 4; // dK/dV, stage s: P^T, 64 x 64
    static constexpr int BARS = PBUF + (DQ ? 0 : STAGES * BN * BN * 4);
    static constexpr int SMEM = BARS + 5 * STAGES * 8 + 8 + 1024;  // + alignment slack
    // setmaxnreg: the loader's and each consumer's registers a thread (dQ,
    // dK/dV); the block's pool, 384 x 168 (__launch_bounds__(384, 1)),
    // holds 128 loader and 256 consumer threads at either pair
    static constexpr int DQ_LOADER = 24, DQ_CONSUMER = 240;
    static constexpr int DKV_LOADER = 40, DKV_CONSUMER = 232;
};

template <int D>
using DqCfg = Cfg<D, true>;
template <int D>
using DkvCfg = Cfg<D, false>;

// A consumer's setmaxnreg.inc waits until the loader has released enough
// registers; if the compiler gave the kernel fewer than the pool assumes,
// it would wait for ever.  Refuse such a build at launch instead.
template <class Kernel>
cudaError_t check_pool(Kernel kernel, int loader, int consumer) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs * 384 >= 128 * loader + 256 * consumer ? cudaSuccess
                                                              : cudaErrorInvalidConfiguration;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return p + ((1024 - (saddr(p) & 1023)) & 1023);
}

// bf16(x * mul) for the 8 bf16 values at p, in place: q * scale as the
// reference takes it (mul is the scale rounded to bf16, so each product
// is exact in float32 before its one rounding).  The swizzle moves whole
// 16-byte chunks within a row, so a tile's rows hold the same chunks.
__device__ __forceinline__ void scale16(uint4* p, float mul) {
    uint4 x = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    *p = x;
}

// dQ's own q tile: this warpgroup's rows [64 wg, 64 wg + 64) of each
// column block, by its 128 threads
template <class C>
__device__ __forceinline__ void scale_own_rows(uint8_t* tile, int wg, float mul, int tid) {
#pragma unroll
    for (int c = 0; c < C::D / 64; ++c)
#pragma unroll
        for (int i = 0; i < 64 * 8 / 128; ++i)     // 8 chunks a 128-byte row
            scale16(reinterpret_cast<uint4*>(tile + (c * C::BM + 64 * wg) * 128) + tid + 128 * i,
                    mul);
}

// dK/dV's streamed q tile, whole, by the 128 loader threads
template <class C>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float mul, int tid) {
#pragma unroll
    for (int i = 0; i < C::TILE / 16 / 128; ++i)
        scale16(reinterpret_cast<uint4*>(tile) + tid + 128 * i, mul);
}

// The A operands of a 64 x BN float32 tile w (as an accumulator holds
// it), PARTS bf16 parts each: a[kk][p] for reduction step kk.
__device__ __forceinline__ void a_parts(uint32_t (&a)[4][PARTS][4], const float (&w)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        bf16_parts<PARTS>(a[kk], 0, w[2 * kk][0], w[2 * kk][1]);          // row g,   k 2t, 2t+1
        bf16_parts<PARTS>(a[kk], 1, w[2 * kk][2], w[2 * kk][3]);          // row g+8, k 2t, 2t+1
        bf16_parts<PARTS>(a[kk], 2, w[2 * kk + 1][0], w[2 * kk + 1][1]);  // row g,   k 2t+8, +9
        bf16_parts<PARTS>(a[kk], 3, w[2 * kk + 1][2], w[2 * kk + 1][3]);  // row g+8, k 2t+8, +9
    }
}

// acc += w . x, w's parts from a_parts, x a streamed tile read MN-major;
// the smallest part first
template <class C>
__device__ __forceinline__ void product3(float (&acc)[C::D / 8][4], const uint32_t (&a)[4][PARTS][4],
                                         const uint8_t* x) {
#pragma unroll
    for (int kk = 0; kk < C::NK; ++kk)
#pragma unroll
        for (int p = PARTS - 1; p >= 0; --p) wgmma_rs<C::D, C::BN>(acc, a[kk][p], x, kk);
}

// Write a warpgroup's 64 x D float32 accumulator times mul as bf16 rows
// (nearest even); rows past t are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int row,
                                           int t, float mul, int tg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (row + 8 * h >= t) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row + 8 * h) * D + 8 * n + 2 * tg) =
                __floats2bfloat162_rn(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
}

template <int J>
__device__ __forceinline__ void zero(float (&a)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// ------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::NTHREADS, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int t, float scale, float qscale, int causal) {
    using C = DqCfg<D>;
    constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint8_t* qs = smem;
    uint8_t* dos = smem + C::OWN;
    uint64_t* own = reinterpret_cast<uint64_t*>(smem + C::BARS);
    uint64_t* full = own + 1;
    uint64_t* empty = full + ST;

    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the longest causal rows first
    int n_k = (t + BN - 1) / BN;
    if (causal) n_k = min(n_k, (q0 + BM) / BN);

    if (threadIdx.x == 0) {
        bar_init(own, 1);
        for (int s = 0; s < ST; ++s) {
            bar_init(full + s, 1);
            bar_init(empty + s, 128 * C::NC);
        }
        bar_init_fence();
    }
    __syncthreads();

    // the warpgroup, the same in every lane of a warp (setmaxnreg needs
    // whole warpgroups, and the two roles never meet again)
    const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    if (role == 0) {                               // the loader
        if constexpr (C::NC == 2) setmaxnreg_dec<C::DQ_LOADER>();
        if (threadIdx.x == 0) {
            bar_arrive_tx(own, 2 * C::OWN);
            load_tile<BM, D>(qs, &tq, q0, bh, own);
            load_tile<BM, D>(dos, &tdo, q0, bh, own);
            for (int i = 0; i < n_k; ++i) {
                const int s = i % ST;
                if (i >= ST) bar_wait(empty + s, ((i / ST) + 1) & 1);
                uint8_t* st = smem + C::RING + s * 2 * C::TILE;
                bar_arrive_tx(full + s, 2 * C::TILE);
                load_tile<BN, D>(st, &tk, i * BN, bh, full + s);
                load_tile<BN, D>(st + C::TILE, &tv, i * BN, bh, full + s);
            }
        }
    } else {                                       // the consumers
        if constexpr (C::NC == 2) setmaxnreg_inc<C::DQ_CONSUMER>();
        const int wg = role - 1;          // rows [64 wg, 64 wg + 64) of the block
        const int tid = threadIdx.x % 128;
        const int lane = tid % 32, g = lane / 4, tg = lane % 4;
        const int row0 = q0 + 64 * wg;
        const int row = row0 + 16 * (tid / 32) + g;    // this thread's rows: row, row + 8
        // tiles this warpgroup's rows see (causal: keys below row0 + 64)
        const int n_mine = causal ? min(n_k, (row0 + 64) / BN) : n_k;
        const bool live = row0 < t;

        float lse_r[2], delta_r[2];
    #pragma unroll
        for (int h = 0; h < 2; ++h) {
            const bool in = row + 8 * h < t;
            lse_r[h] = in ? lse[(size_t)bh * t + row + 8 * h] : 0.f;
            delta_r[h] = in ? delta[(size_t)bh * t + row + 8 * h] : 0.f;
        }

        bar_wait(own, 0);
        scale_own_rows<C>(qs, wg, qscale, tid);        // q * scale in bf16, once
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);

        float acc[D / 8][4];
        zero(acc);
        for (int i = 0; i < n_k; ++i) {
            const int s = i % ST;
            bar_wait(full + s, (i / ST) & 1);
            if (live && i < n_mine) {
                const uint8_t* ks = smem + C::RING + s * 2 * C::TILE;
                const uint8_t* vs = ks + C::TILE;
                float sp[8][4], dp[8][4];              // S then P; dP then dS
                wg_fence();
    #pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss64(sp, desc_k<BM>(qs, 64 * wg, kk), desc_k<BN>(ks, 0, kk), kk > 0);
    #pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss64(dp, desc_k<BM>(dos, 64 * wg, kk), desc_k<BN>(vs, 0, kk), kk > 0);
                wg_commit();
                wg_wait<0>();
                keep(sp);
                keep(dp);

                const int k0 = i * BN;
                // the causal diagonal tile, or the ragged last one
                const bool edge = (causal && k0 + BN - 1 > row0) || k0 + BN > t;
    #pragma unroll
                for (int j = 0; j < 8; ++j)
    #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = row + 8 * (e >> 1);
                        const int col = k0 + 8 * j + 2 * tg + (e & 1);
                        float sv = sp[j][e];
                        if (edge && causal && col > r) sv = -1e30f;
                        float p = expf(sv - lse_r[e >> 1]);
                        if (edge && col >= t) p = 0.f;
                        dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
                    }
                uint32_t a[4][PARTS][4];
                a_parts(a, dp);
                wg_fence();
                product3<C>(acc, a, ks);
                wg_commit();
                wg_wait<0>();
                keep(acc);
                keep(a);
            }
            bar_arrive(empty + s);
        }
        store_rows<D>(dq + (size_t)bh * t * D, acc, row, t, scale, tg);
    }
}

// ---------------------------------------------------------------- dK/dV

// P^T = exp(S^T - lse) in place on S^T's accumulator x: x[j][e] is key
// krow + 8 (e >> 1) against query q0 + 8j + 2tg + (e & 1) (ls: the tile's
// lse by query); causal cells (key > query) at -1e30, queries past t 0.
// Each 8-query block also goes to pb, thread by thread, for the consumer
// that forms dS^T.
__device__ __forceinline__ void p_transposed(float (&x)[8][4], const float* ls, float4* pb,
                                             int krow, int q0, int t, bool edge, int causal,
                                             int tg, int tid) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * tg;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int kr = krow + 8 * (e >> 1);
            const int qr = q0 + qc + (e & 1);
            float sv = x[j][e];
            if (edge && causal && kr > qr) sv = -1e30f;
            float p = expf(sv - ((e & 1) ? l2.y : l2.x));
            if (edge && qr >= t) p = 0.f;
            x[j][e] = p;
        }
        pb[j * 128 + tid] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
    }
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::NTHREADS, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int t, float qscale,
                      int causal) {
    using C = DkvCfg<D>;
    constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint8_t* ks = smem;
    uint8_t* vs = smem + C::OWN;
    float* rows = reinterpret_cast<float*>(smem + C::ROWS);   // stage s: lse, delta
    float4* pbuf = reinterpret_cast<float4*>(smem + C::PBUF); // stage s: P^T, thread by thread
    uint64_t* own = reinterpret_cast<uint64_t*>(smem + C::BARS);
    uint64_t* raw = own + 1;                       // a stage's TMA landed
    uint64_t* full = raw + ST;                     // ... and its q is scaled
    uint64_t* empty = full + ST;
    uint64_t* pready = empty + ST;                 // a stage's P^T is in pbuf

    const int bh = blockIdx.x;
    const int k0 = blockIdx.y * BM;                // causal: the most q tiles first
    const int n_q = (t + BN - 1) / BN;
    // causal: q tiles above k0 see none of these keys; every later tile
    // sees some (BM = BN), so no tile of the walk is skipped
    const int qt0 = causal ? k0 / BN : 0;
    const int n = n_q - qt0;

    if (threadIdx.x == 0) {
        bar_init(own, 1);
        for (int s = 0; s < ST; ++s) {
            bar_init(raw + s, 1);
            bar_init(full + s, 128);
            bar_init(empty + s, 256);
            bar_init(pready + s, 128);
        }
        bar_init_fence();
    }
    __syncthreads();

    // the warpgroup, the same in every lane of a warp (setmaxnreg needs
    // whole warpgroups, and the three roles never meet again)
    const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    if (role == 0) {                               // the loader
        setmaxnreg_dec<C::DKV_LOADER>();
        const int tid = threadIdx.x;
        if (tid == 0) {
            bar_arrive_tx(own, 2 * C::OWN);
            load_tile<BM, D>(ks, &tk, k0, bh, own);
            load_tile<BM, D>(vs, &tv, k0, bh, own);
        }
        for (int i = 0; i < n; ++i) {
            const int s = i % ST, q0 = (qt0 + i) * BN;
            uint8_t* st = smem + C::RING + s * 2 * C::TILE;
            if (i >= ST) bar_wait(empty + s, ((i / ST) + 1) & 1);
            if (tid == 0) {
                bar_arrive_tx(raw + s, 2 * C::TILE);
                load_tile<BN, D>(st, &tq, q0, bh, raw + s);
                load_tile<BN, D>(st + C::TILE, &tdo, q0, bh, raw + s);
            }
            // lse (threads 0-63) and delta (64-127) of the tile's rows
            const int r = q0 + tid % BN;
            const float* src = tid < BN ? lse : delta;
            rows[s * 2 * BN + tid] = r < t ? src[(size_t)bh * t + r] : 0.f;
            bar_wait(raw + s, (i / ST) & 1);
            scale_tile<C>(st, qscale, tid);        // q * scale in bf16, once a block
            fence_proxy_async();
            bar_arrive(full + s);
        }
    } else {
        // role 1: S^T, P^T and dV; role 2: dP^T, dS^T and dK, with P^T
        // from role 1 through shared memory.  Each holds one 64 x D
        // accumulator for the block's 64 keys.
        setmaxnreg_inc<C::DKV_CONSUMER>();
        const int tid = threadIdx.x % 128;
        const int lane = tid % 32, g = lane / 4, tg = lane % 4;
        const int krow = k0 + 16 * (tid / 32) + g;   // this thread's key rows: krow, krow + 8

        bar_wait(own, 0);
        float acc[D / 8][4];
        zero(acc);
        float x[8][4];
        uint32_t a[4][PARTS][4];
        if (role == 1) {
            for (int i = 0; i < n; ++i) {
                const int s = i % ST, q0 = (qt0 + i) * BN;
                const uint8_t* qst = smem + C::RING + s * 2 * C::TILE;
                const float* ls = rows + s * 2 * BN;
                float4* pb = pbuf + s * (BN * BN / 4);
                // the causal diagonal tile, or the ragged last one
                const bool edge = (causal && k0 + BM - 1 > q0) || q0 + BN > t;
                bar_wait(full + s, (i / ST) & 1);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss64(x, desc_k<BM>(ks, 0, kk), desc_k<BN>(qst, 0, kk), kk > 0);
                wg_commit();
                wg_wait<0>();
                keep(x);
                p_transposed(x, ls, pb, krow, q0, t, edge, causal, tg, tid);
                bar_arrive(pready + s);
                a_parts(a, x);                     // P^T
                wg_fence();
                product3<C>(acc, a, qst + C::TILE);   // dV += P^T dO
                wg_commit();
                wg_wait<0>();
                keep(acc);
                keep(a);
                bar_arrive(empty + s);
            }
        } else {
            for (int i = 0; i < n; ++i) {
                const int s = i % ST;
                const uint8_t* qst = smem + C::RING + s * 2 * C::TILE;
                const float* dl = rows + s * 2 * BN + BN;
                const float4* pb = pbuf + s * (BN * BN / 4);
                bar_wait(full + s, (i / ST) & 1);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss64(x, desc_k<BM>(vs, 0, kk), desc_k<BN>(qst + C::TILE, 0, kk),
                               kk > 0);
                wg_commit();
                wg_wait<0>();
                keep(x);
                bar_wait(pready + s, (i / ST) & 1);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tg);
                    const float4 p = pb[j * 128 + tid];
                    x[j][0] = p.x * (x[j][0] - d2.x);
                    x[j][1] = p.y * (x[j][1] - d2.y);
                    x[j][2] = p.z * (x[j][2] - d2.x);
                    x[j][3] = p.w * (x[j][3] - d2.y);
                }
                a_parts(a, x);                     // dS^T
                wg_fence();
                product3<C>(acc, a, qst);          // dK += dS^T (q*scale)
                wg_commit();
                wg_wait<0>();
                keep(acc);
                keep(a);
                bar_arrive(empty + s);
            }
        }
        store_rows<D>((role == 1 ? dv : dk) + (size_t)bh * t * D, acc, krow, t, 1.f, tg);
    }
}

// ------------------------------------- head_dim 192 and 256: two consumers

// A block of two consumer warpgroups and no loader warpgroup: 256 threads,
// two warps a register file, so ptxas may give a thread 255 registers.
// Thread 0 of consumer 1 issues every TMA load.
constexpr int PAIR_THREADS = 256;

// q * scale takes no rounding where the scale (already bf16) is a power of
// two: bf16(q * scale) = q * scale (q past bf16's normal range aside), and
// a product with q * scale is the product with q times the scale, exactly.
__device__ __forceinline__ bool power_of_two(float x) {
    const uint32_t e = (__float_as_uint(x) >> 23) & 0xFF;
    return (__float_as_uint(x) & 0x7FFFFF) == 0 && e != 0 && e != 0xFF;
}

template <int D_>
struct DkvPair {
    static constexpr int D = D_;
    static constexpr int BM = 64, BN = 64;         // keys of a block, queries of a tile
    static constexpr int NK = BN / 16;
    static constexpr int ST = D_ == 256 ? 2 : 3;   // stages of q and dO
    static constexpr int NPB = 2;                  // P^T buffers
    static constexpr int OWN = BM * D * 2;         // K, V of the block
    static constexpr int TILE = BN * D * 2;        // a q or dO tile
    static constexpr int RING = 2 * OWN;           // stage s: q at RING + 2s TILE, dO after it
    static constexpr int PBUF = RING + ST * 2 * TILE;   // P^T, 64 x 64 float32 a buffer
    static constexpr int BARS = PBUF + NPB * BM * BN * 4;
    static constexpr int SMEM = BARS + (1 + 3 * ST + 2 * NPB) * 8 + 1024;
};

// s (64 x 64) = A . B^T over D values, both K-major in shared memory: rows
// of a 64-row tile a against a 64-row tile b
template <int D>
__device__ __forceinline__ void product_ss(float (&s)[8][4], const uint8_t* a, const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss64(s, desc_k<64>(a, 0, kk), desc_k<64>(b, 0, kk), kk > 0);
}

// P^T = exp(S^T * smul - lse) in place on S^T's accumulator x: x[j][e] is
// key krow + 8 (e >> 1) against query q0 + 8j + 2tg + (e & 1), ls[j][e]
// that query's lse; causal cells (key > query) at -1e30, queries past t 0.
// Each 8-query block also goes to pb, thread by thread.
__device__ __forceinline__ void p_transposed_pair(float (&x)[8][4], const float (&ls)[8][2],
                                                  float4* pb, int krow, int q0, int t, bool edge,
                                                  int causal, float smul, int tg, int tid) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int kr = krow + 8 * (e >> 1);
            const int qr = q0 + 8 * j + 2 * tg + (e & 1);
            float sv = x[j][e] * smul;
            if (edge && causal && kr > qr) sv = -1e30f;
            float p = expf(sv - ls[j][e & 1]);
            if (edge && qr >= t) p = 0.f;
            x[j][e] = p;
        }
        pb[j * 128 + tid] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
    }
}

// rows[bh * t + q] for this thread's query columns q0 + 8j + 2tg (+1) of a
// tile; 0 past t
__device__ __forceinline__ void tile_rows(float (&r)[8][2], const float* rows, int bh, int t,
                                          int q0, int tg) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int q = q0 + 8 * j + 2 * tg + e;
            r[j][e] = q < t ? rows[(size_t)bh * t + q] : 0.f;
        }
}

template <int D>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
flash_dkv_bf16_pair_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int t, float qscale,
                           int causal) {
    using C = DkvPair<D>;
    constexpr int BM = C::BM, BN = C::BN, ST = C::ST, NPB = C::NPB;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint8_t* ks = smem;
    uint8_t* vs = smem + C::OWN;
    float4* pbuf = reinterpret_cast<float4*>(smem + C::PBUF);
    uint64_t* own = reinterpret_cast<uint64_t*>(smem + C::BARS);
    uint64_t* raw = own + 1;                       // a stage's TMA landed
    uint64_t* full = raw + ST;                     // ... and its q is scaled (not exact)
    uint64_t* empty = full + ST;
    uint64_t* pready = empty + ST;                 // P^T buffer b written
    uint64_t* pfree = pready + NPB;                // ... and read

    const int bh = blockIdx.x;
    const int k0 = blockIdx.y * BM;                // causal: the most q tiles first
    const int n_q = (t + BN - 1) / BN;
    const int qt0 = causal ? k0 / BN : 0;          // see flash_dkv_bf16_kernel
    const int n = n_q - qt0;
    // an exact scale: q is read as it lands, and S^T and dK take the scale
    const bool exact = power_of_two(qscale);
    const float smul = exact ? qscale : 1.f;

    if (threadIdx.x == 0) {
        bar_init(own, 1);
        for (int s = 0; s < ST; ++s) {
            bar_init(raw + s, 1);
            bar_init(full + s, 128);
            bar_init(empty + s, PAIR_THREADS);
        }
        for (int b = 0; b < NPB; ++b) {
            bar_init(pready + b, 128);
            bar_init(pfree + b, 128);
        }
        bar_init_fence();
    }
    __syncthreads();

    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, g = lane / 4, tg = lane % 4;
    const int krow = k0 + 16 * (tid / 32) + g;     // this thread's key rows: krow, krow + 8
    const bool loader = wg == 1 && tid == 0;
    auto load = [&](int i) {
        const int s = i % ST, q0 = (qt0 + i) * BN;
        uint8_t* st = smem + C::RING + s * 2 * C::TILE;
        bar_arrive_tx(raw + s, 2 * C::TILE);
        load_tile<BN, D>(st, &tq, q0, bh, raw + s);
        load_tile<BN, D>(st + C::TILE, &tdo, q0, bh, raw + s);
    };
    if (loader) {
        bar_arrive_tx(own, 2 * C::OWN);
        load_tile<BM, D>(ks, &tk, k0, bh, own);
        load_tile<BM, D>(vs, &tv, k0, bh, own);
        for (int i = 0; i < min(n, ST); ++i) load(i);
    }

    bar_wait(own, 0);
    float acc[D / 8][4];                           // dV (consumer 0), dK (consumer 1)
    zero(acc);
    float x[8][4];
    uint32_t a[4][PARTS][4];
    if (wg == 0) {                                 // S^T, P^T and dV
        for (int i = 0; i < n; ++i) {
            const int s = i % ST, q0 = (qt0 + i) * BN;
            const uint8_t* qst = smem + C::RING + s * 2 * C::TILE;
            // the causal diagonal tile, or the ragged last one
            const bool edge = (causal && k0 + BM - 1 > q0) || q0 + BN > t;
            float ls[8][2];
            tile_rows(ls, lse, bh, t, q0, tg);
            bar_wait((exact ? raw : full) + s, (i / ST) & 1);
            wg_fence();
            product_ss<D>(x, ks, qst);
            wg_commit();
            wg_wait<0>();
            keep(x);
            if (i >= NPB) bar_wait(pfree + i % NPB, ((i / NPB) + 1) & 1);
            p_transposed_pair(x, ls, pbuf + (i % NPB) * (BN * BN / 4), krow, q0, t, edge, causal,
                              smul, tg, tid);
            bar_arrive(pready + i % NPB);
            a_parts(a, x);                         // P^T
            wg_fence();
            product3<C>(acc, a, qst + C::TILE);    // dV += P^T dO
            wg_commit();
            wg_wait<0>();
            keep(acc);
            keep(a);
            bar_arrive(empty + s);
        }
    } else {                                       // dP^T, dS^T and dK; thread 0 loads
        // not exact: this warpgroup rounds each q tile to bf16(q * scale),
        // tile i + 1 while tile i's dP^T is on the tensor core
        auto scale_q = [&](int i) {
            const int s = i % ST;
            bar_wait(raw + s, (i / ST) & 1);
            scale_tile<C>(smem + C::RING + s * 2 * C::TILE, qscale, tid);
            fence_proxy_async();
            bar_arrive(full + s);
        };
        if (!exact) scale_q(0);
        for (int i = 0; i < n; ++i) {
            const int s = i % ST, q0 = (qt0 + i) * BN;
            const uint8_t* qst = smem + C::RING + s * 2 * C::TILE;
            const float4* pb = pbuf + (i % NPB) * (BN * BN / 4);
            float dl[8][2];
            tile_rows(dl, delta, bh, t, q0, tg);
            bar_wait(raw + s, (i / ST) & 1);
            wg_fence();
            product_ss<D>(x, vs, qst + C::TILE);
            wg_commit();
            if (!exact && i + 1 < n) scale_q(i + 1);
            wg_wait<0>();
            keep(x);
            bar_wait(pready + i % NPB, (i / NPB) & 1);
#pragma unroll
            for (int j = 0; j < 8; ++j) {            // dS^T = P^T (dP^T - delta)
                const float4 p = pb[j * 128 + tid];
                x[j][0] = p.x * (x[j][0] - dl[j][0]);
                x[j][1] = p.y * (x[j][1] - dl[j][1]);
                x[j][2] = p.z * (x[j][2] - dl[j][0]);
                x[j][3] = p.w * (x[j][3] - dl[j][1]);
            }
            bar_arrive(pfree + i % NPB);
            a_parts(a, x);                         // dS^T
            if (!exact) bar_wait(full + s, (i / ST) & 1);   // every thread's scaling of q
            wg_fence();
            product3<C>(acc, a, qst);              // dK += dS^T q (q * scale where not exact)
            wg_commit();
            wg_wait<0>();
            keep(acc);
            keep(a);
            bar_arrive(empty + s);
            if (loader && i + ST < n) {
                bar_wait(empty + s, (i / ST) & 1);
                load(i + ST);
            }
        }
    }
    store_rows<D>((wg == 0 ? dv : dk) + (size_t)bh * t * D, acc, krow, t, wg == 0 ? 1.f : smul,
                  tg);
}

// the tensor maps of q, k, v and dO (wgmma_tile.cuh's make_map); false
// where one is refused
bool make_maps(CUtensorMap (&m)[4], const bf16* q, const bf16* k, const bf16* v,
               const bf16* dout, int bh, int t, int d) {
    return make_map(&m[0], q, bh, t, d) && make_map(&m[1], k, bh, t, d) &&
           make_map(&m[2], v, bh, t, d) && make_map(&m[3], dout, bh, t, d);
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* delta, bf16* dq, int bh, int t,
                      float scale, float qscale, int causal, cudaStream_t stream) {
    using C = DqCfg<D>;
    CUtensorMap m[4];
    if (!make_maps(m, q, k, v, dout, bh, t, D)) return cudaErrorInvalidValue;
    if constexpr (C::NC == 2) {
        static const cudaError_t pool =
            check_pool(flash_dq_bf16_kernel<D>, C::DQ_LOADER, C::DQ_CONSUMER);
        if (pool != cudaSuccess) return pool;
    }
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (t + C::BM - 1) / C::BM);
    flash_dq_bf16_kernel<D><<<grid, C::NTHREADS, C::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], lse, delta, dq, t, scale, qscale, causal);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dk, bf16* dv, int bh, int t,
                       float qscale, int causal, cudaStream_t stream) {
    CUtensorMap m[4];
    if (!make_maps(m, q, k, v, dout, bh, t, D)) return cudaErrorInvalidValue;
    if constexpr (D > 128) {
        using P = DkvPair<D>;
        cudaError_t err = cudaFuncSetAttribute(
            flash_dkv_bf16_pair_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
        if (err != cudaSuccess) return err;
        dim3 grid(bh, (t + P::BM - 1) / P::BM);
        flash_dkv_bf16_pair_kernel<D><<<grid, PAIR_THREADS, P::SMEM, stream>>>(
            m[0], m[1], m[2], m[3], lse, delta, dk, dv, t, qscale, causal);
        return cudaGetLastError();
    } else {
        using C = DkvCfg<D>;
        static const cudaError_t pool =
            check_pool(flash_dkv_bf16_kernel<D>, C::DKV_LOADER, C::DKV_CONSUMER);
        if (pool != cudaSuccess) return pool;
        cudaError_t err = cudaFuncSetAttribute(
            flash_dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (err != cudaSuccess) return err;
        dim3 grid(bh, (t + C::BM - 1) / C::BM);
        flash_dkv_bf16_kernel<D><<<grid, C::NTHREADS, C::SMEM, stream>>>(
            m[0], m[1], m[2], m[3], lse, delta, dk, dv, t, qscale, causal);
        return cudaGetLastError();
    }
}

// what the compiler gave a kernel: registers a thread, local memory a
// thread (spills), dynamic shared memory and threads a block
template <class Kernel>
int attributes(Kernel kernel, int smem, int threads, int* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = smem;
    out[3] = threads;
    return 0;
}

template <int D>
int attributes_of(int dkv, int* out) {
    if (!dkv) return attributes(flash_dq_bf16_kernel<D>, DqCfg<D>::SMEM, DqCfg<D>::NTHREADS, out);
    if constexpr (D > 128)
        return attributes(flash_dkv_bf16_pair_kernel<D>, DkvPair<D>::SMEM, PAIR_THREADS, out);
    else
        return attributes(flash_dkv_bf16_kernel<D>, DkvCfg<D>::SMEM, DkvCfg<D>::NTHREADS, out);
}

}  // namespace

// The instance that a launch at head_dim d takes (dkv = 0: dQ, 1: dK/dV):
// out[0..3] = registers a thread, local bytes a thread, dynamic shared
// bytes, threads a block.  Launches nothing.
extern "C" int zoo_flash_bwd_bf16_attributes(int dkv, int d, int* out) {
    switch (d) {
        case 64: return attributes_of<64>(dkv, out);
        case 128: return attributes_of<128>(dkv, out);
        case 192: return attributes_of<192>(dkv, out);
        case 256: return attributes_of<256>(dkv, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int zoo_flash_attention_dq_bf16(const __nv_bfloat16* q,
                                           const __nv_bfloat16* k,
                                           const __nv_bfloat16* v,
                                           const __nv_bfloat16* dout,
                                           const float* lse, const float* delta,
                                           __nv_bfloat16* dq, int bh, int t, int d,
                                           float scale, float qscale, int causal,
                                           void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    switch (d) {
        case 64:
            return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, t, scale, qscale,
                                      causal, s);
        case 128:
            return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, t, scale, qscale,
                                       causal, s);
        case 192:
            return (int)launch_dq<192>(q, k, v, dout, lse, delta, dq, bh, t, scale, qscale,
                                       causal, s);
        case 256:
            return (int)launch_dq<256>(q, k, v, dout, lse, delta, dq, bh, t, scale, qscale,
                                       causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" int zoo_flash_attention_dkv_bf16(const __nv_bfloat16* q,
                                            const __nv_bfloat16* k,
                                            const __nv_bfloat16* v,
                                            const __nv_bfloat16* dout,
                                            const float* lse, const float* delta,
                                            __nv_bfloat16* dk, __nv_bfloat16* dv,
                                            int bh, int t, int d, float qscale,
                                            int causal, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    switch (d) {
        case 64:
            return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, t, qscale,
                                       causal, s);
        case 128:
            return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, t, qscale,
                                        causal, s);
        case 192:
            return (int)launch_dkv<192>(q, k, v, dout, lse, delta, dk, dv, bh, t, qscale,
                                        causal, s);
        case 256:
            return (int)launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh, t, qscale,
                                        causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
