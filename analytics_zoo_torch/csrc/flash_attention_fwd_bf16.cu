// Flash-attention forward on bfloat16 inputs for Hopper (sm_90a)
// (zoo_flash_attention_fwd_bf16), on wgmma, TMA and mbarriers
// (wgmma_tile.cuh).  The float32 forward stays in flash_attention_fwd.cu.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_kernel
//           (launched from _flash_fwd_impl) on bf16 q, k, v.
//
// Computes, for each (batch*head) slice of q, k, v laid out (BH, T, D), in
// the reference's order:
//   qs  = bf16(q * bf16(scale))          (the scale rounded, the exact
//                                          product rounded once)
//   S   = qs K^T                         (bf16 products, float32 sums;
//                                          causal: -1e30 where key > query,
//                                          keys past T: -inf)
//   an online softmax in float32 over BN-key tiles: the running max m
//   (from -1e30) and sum l of the unrounded p = exp(s - m); per tile
//   O = O * exp(m_old - m_new) + bf16(p) V, P rounded to bf16 (nearest
//   even, as the reference's astype) at the tile's running max;
//   O   = bf16(acc / max(l, 1e-30)),  LSE = m + log(max(l, 1e-30)) float32.
//
// What bounds it on the H100: at bench_attention's (4, 8, 4096, 128),
// causal, the two products are 2 * 2 * B*H * T^2/2 * D = 1.37e11 FLOP at
// 989 TFLOP/s: 0.139 ms, against 0.04 ms to move q, k, v, O and LSE (134
// MB): bound by operations, at the tensor cores' bf16 rate, which only
// wgmma reaches.  At D = 128 a row takes one exp per 512 FLOP of products,
// and the SM's 16 exps a clock against ~4096 bf16 FLOP a clock make the
// exps alone half the products' time: the softmax has to run while the
// tensor core works, or the kernel cannot pass ~0.65 of the bound.
//
// Design (the mma.sync kernel this replaces reached 0.19 of the bound;
// each of its warps read a streamed tile's B fragments for its own 16
// rows, and nothing overlapped the softmax with the products):
//   - A block owns BM = 128 query rows and has 288 threads: warpgroups 0
//     and 1 are consumers of 64 rows each, warp 8 is the loader (a wgmma
//     warpgroup must start at a warp index that is a multiple of 4).  One
//     thread of the loader loads the block's q tile once by TMA, then
//     streams BN = 128-key K and V tiles through a ring of STAGES stages:
//     K and V of a stage each complete on a `full` mbarrier and are
//     released on an `empty` one of their own.  Rows past T land as zeros
//     (3-D tensor maps); only the ragged last tile and the causal diagonal
//     tile are masked.
//   - Each consumer rounds its own 64 rows of q * scale to bf16 once, in
//     shared memory, and takes S = qs K^T as wgmma m64n128k16 with both
//     operands K-major in shared memory; the tensor core reads a K tile
//     once for 64 rows.
//   - The softmax runs on the accumulator's layout (a row's max over the
//     four lanes of a quad, two shuffles).  P is packed to bf16 pairs,
//     which are the register A operand of O += P V (wgmma m64nDk16), V
//     read MN-major from the same shared tile TMA wrote: no shuffles and
//     no trip through shared memory.
//   - Overlap (PINGPONG): the two consumers take turns at the tensor core
//     on named barriers 3 and 4.  A consumer's turn issues its P V of the
//     tile before, waits for it, and issues its S of this tile; then it
//     hands the turn over and runs this tile's softmax while the other
//     consumer's two products are on the tensor core.
//   - Registers are what shapes the rest.  A wgmma kernel of 288 (or 384)
//     threads is compiled within 168 registers a thread: three warps
//     share each of the SM's four register files, and a 224-register build
//     at 288 threads is refused at launch.  setmaxnreg does not raise what
//     ptxas compiles to.  At D = 128 a consumer holds O (64) and S (64),
//     and P (32) while its P V runs: issuing the next S before that P V
//     has retired (FlashAttention-3's overlap within a warpgroup) keeps all
//     three live, and ptxas then spills and serializes the wgmmas.  A
//     256-thread build of it (the loader in a consumer, 255 registers, no
//     spill) was slower in turns (PERF.md).
//   - Causal blocks launch heaviest first: the grid is (B*H, T/BM) with
//     the query block on y, reversed.  A block walks the key tiles up to
//     its diagonal and no further.
//   - No atomics: each output row belongs to one consumer of one block,
//     so two launches give bit-identical O and LSE.
//   Shared memory at D = 128: q 32 KB and two stages of K and V, 32 KB
//   each: 161 KB with the barriers and alignment; at D = 64, 81 KB.
//
// Head_dim 192 and 256 (Cfg).  O alone is D / 2 registers a consumer
// thread (96, 128), and a 128-key tile's S another 64: the design above
// at BN = 128 would pass the 168 registers and, with 192 or 256 KB of K/V
// stages, the 227 KB of shared memory.  Both widths take 64-key tiles
// (S 32 registers; the online softmax and P's rounding run per 64-key
// tile).  At 192 the two consumers keep their turns (O 96 + S 32
// registers fit the 168 without a spill; q 48 KB, stages 96 KB: 145 KB).
// At 256 O + S alone are 160, so a block is one consumer warpgroup of 64
// rows and the loader warp, 160 threads, for which ptxas may give a
// thread 255 registers (it takes 235); it takes no turns (q 32 KB, stages
// 128 KB: 161 KB, one block an SM).  P V's
// 192 or 256 columns go to the tensor core as a 128- and a 64- or
// 128-column wgmma on the same P registers (wgmma_rs).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace wgmma_tile;

// the two consumers take turns to issue their products (see above)
constexpr bool PINGPONG = true;

template <int D_>
struct Cfg {
    static constexpr int D = D_;
    static constexpr int NC = D_ <= 192 ? 2 : 1;   // consumer warpgroups (see above)
    static constexpr int BM = 64 * NC;             // query rows a block owns, 64 a consumer
    static constexpr int BN = D_ <= 128 ? 128 : 64;   // keys of a streamed tile
    static constexpr int STAGES = 2;
    static constexpr int NTHREADS = 128 * NC + 32; // the consumer warpgroups, a loader warp
    static constexpr bool TURNS = PINGPONG && NC == 2;
    static constexpr int NJ = BN / 8;              // 8-column blocks of S
    static constexpr int OWN = BM * D * 2;         // bytes of the q tile
    static constexpr int TILE = BN * D * 2;        // bytes of a K or V tile
    static constexpr int RING = OWN;               // stage s: K at RING + 2s TILE, V after it
    static constexpr int BARS = RING + STAGES * 2 * TILE;
    static constexpr int SMEM = BARS + (1 + 4 * STAGES) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return p + ((1024 - (saddr(p) & 1023)) & 1023);
}

// bf16(x * mul) for this consumer's rows [64 wg, 64 wg + 64) of the q
// tile, in place, by its 128 threads: q * scale as the reference takes it
// (mul is the scale rounded to bf16, so each product is exact in float32
// before its one rounding).  The swizzle moves whole 16-byte chunks
// within a row, so a row holds the same chunks.
template <class C>
__device__ __forceinline__ void scale_own_rows(uint8_t* tile, int wg, float mul, int tid) {
#pragma unroll
    for (int c = 0; c < C::D / 64; ++c)
#pragma unroll
        for (int i = 0; i < 64 * 8 / 128; ++i) {   // 8 chunks a 128-byte row
            uint4* p = reinterpret_cast<uint4*>(tile + (c * C::BM + 64 * wg) * 128) + tid +
                       128 * i;
            uint4 x = *p;
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h[e]);
                h[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
            }
            *p = x;
        }
}

// S = qs . K^T for this consumer's 64 rows (overwrites s)
template <class C>
__device__ __forceinline__ void product_s(float (&s)[C::NJ][4], const uint8_t* qs, int wg,
                                          const uint8_t* ks) {
#pragma unroll
    for (int kk = 0; kk < C::D / 16; ++kk) {
        const uint64_t a = desc_k<C::BM>(qs, 64 * wg, kk), b = desc_k<C::BN>(ks, 0, kk);
        if constexpr (C::BN == 64)
            wgmma_ss64(s, a, b, kk > 0);
        else if (kk == 0)
            wgmma_ss128_first(s, a, b);
        else
            wgmma_ss128(s, a, b);
    }
}

// O += P . V, P from registers, V read MN-major
template <class C>
__device__ __forceinline__ void product_pv(float (&o)[C::D / 8][4], const uint32_t (&p)[C::BN / 16][4],
                                           const uint8_t* vs) {
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) wgmma_rs<C::D, C::BN>(o, p[kk], vs, kk);
}

// The online softmax of one tile of scores s (keys k0 ..), for this
// thread's rows `row` and `row + 8` (the consumer's first row row0):
// masks it, moves the running max m, leaves p = exp(s - m) in s, sets
// corr = exp(m_old - m_new) and l = l * corr + the row's part of sum(p).
// Each lane keeps its own columns' part of l.
template <int NJ>
__device__ __forceinline__ void online_softmax(float (&s)[NJ][4], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int k0, int row, int row0,
                                               int t, int causal, int tg) {
    // the causal diagonal tile, or the ragged last one
    if ((causal && k0 + 8 * NJ - 1 > row0) || k0 + 8 * NJ > t) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = row + 8 * (e >> 1);
                const int col = k0 + 8 * j + 2 * tg + (e & 1);
                // keys past T: no part in the max, p = exp(-inf) = 0 (m is
                // finite from its start at -1e30)
                if (col >= t) s[j][e] = -INFINITY;
                else if (causal && col > r) s[j][e] = -1e30f;
            }
    }
    float mb[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
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
            s[j][e] = expf(s[j][e] - m[e >> 1]);
            ls[e >> 1] += s[j][e];
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// P rounded to bf16 (nearest even) as the A operands of O += P V:
// accumulator blocks 2kk and 2kk + 1 are reduction step kk
template <int NJ>
__device__ __forceinline__ void pack_p(uint32_t (&a)[NJ / 2][4], const float (&w)[NJ][4]) {
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
        a[kk][0] = pack_bf16(w[2 * kk][0], w[2 * kk][1]);          // row g,   k 2t, 2t+1
        a[kk][1] = pack_bf16(w[2 * kk][2], w[2 * kk][3]);          // row g+8, k 2t, 2t+1
        a[kk][2] = pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]);  // row g,   k 2t+8, +9
        a[kk][3] = pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3]);  // row g+8, k 2t+8, +9
    }
}

// The turns of the two consumers at the tensor core: consumer w waits at
// barrier 3 + w for its turn, and when it has issued its products hands
// the turn to the other at barrier 4 - w (each 256 threads: 128 waiting,
// 128 arriving).  A block of one consumer takes no turns.
template <class C>
__device__ __forceinline__ void my_turn(int wg) {
    if (C::TURNS) named_bar_sync(3 + wg, 256);
}

template <class C>
__device__ __forceinline__ void your_turn(int wg) {
    if (C::TURNS) named_bar_arrive(4 - wg, 256);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int t, float qscale, int causal) {
    using C = Cfg<D>;
    constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, NJ = C::NJ;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint8_t* qs = smem;
    uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::BARS);
    uint64_t* full_k = qbar + 1;
    uint64_t* full_v = full_k + ST;
    uint64_t* empty_k = full_v + ST;
    uint64_t* empty_v = empty_k + ST;

    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the longest causal rows first
    int n = (t + BN - 1) / BN;                           // key tiles the block walks
    if (causal) n = min(n, (q0 + BM + BN - 1) / BN);

    if (threadIdx.x == 0) {
        bar_init(qbar, 1);
        for (int s = 0; s < ST; ++s) {
            bar_init(full_k + s, 1);
            bar_init(full_v + s, 1);
            bar_init(empty_k + s, 128 * C::NC);
            bar_init(empty_v + s, 128 * C::NC);
        }
        bar_init_fence();
    }
    __syncthreads();

    // the warpgroup, the same in every lane of a warp
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    if (wg == C::NC) {                             // the loader warp
        if (threadIdx.x == 128 * C::NC) {
            bar_arrive_tx(qbar, C::OWN);
            load_tile<BM, D>(qs, &tq, q0, bh, qbar);
            for (int i = 0; i < n; ++i) {
                const int s = i % ST;
                const uint32_t released = ((i / ST) + 1) & 1;
                uint8_t* st = smem + C::RING + s * 2 * C::TILE;
                if (i >= ST) bar_wait(empty_k + s, released);
                bar_arrive_tx(full_k + s, C::TILE);
                load_tile<BN, D>(st, &tk, i * BN, bh, full_k + s);
                if (i >= ST) bar_wait(empty_v + s, released);
                bar_arrive_tx(full_v + s, C::TILE);
                load_tile<BN, D>(st + C::TILE, &tv, i * BN, bh, full_v + s);
            }
        }
        return;
    }

    // the consumers: rows [64 wg, 64 wg + 64) of the block
    const int tid = threadIdx.x % 128;
    const int tg = tid % 4;
    const int row0 = q0 + 64 * wg;
    const int row = row0 + 16 * (tid / 32) + (tid % 32) / 4;   // this thread's rows: row, row + 8

    bar_wait(qbar, 0);
    scale_own_rows<C>(qs, wg, qscale, tid);        // q * scale in bf16, once
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (C::TURNS && wg == 0) named_bar_arrive(3, 256);   // the first turn is consumer 0's

    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float sc[NJ][4];                               // S, then p = exp(s - m)
    uint32_t p[BN / 16][4];                        // p in bf16: the A operand of P V
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, corr[2];

    // Turn 0: tile 0's S; turn i (0 < i < n): tile i-1's P V (waited for:
    // P's registers are then free), then tile i's S; turn n: tile n-1's
    // P V.  Out of turn, the softmax of the S just taken.
    bar_wait(full_k, 0);
    my_turn<C>(wg);
    wg_fence();
    product_s<C>(sc, qs, wg, smem + C::RING);
    wg_commit();
    your_turn<C>(wg);
    wg_wait<0>();
    keep(sc);
    bar_arrive(empty_k);
    online_softmax(sc, m, l, corr, 0, row, row0, t, causal, tg);
    pack_p(p, sc);
    for (int i = 1; i < n; ++i) {
        const int s = i % ST, sp = (i - 1) % ST;
        const uint8_t* ks = smem + C::RING + s * 2 * C::TILE;
        bar_wait(full_k + s, (i / ST) & 1);
        bar_wait(full_v + sp, ((i - 1) / ST) & 1);
        my_turn<C>(wg);
        wg_fence();
        product_pv<C>(acc, p, smem + C::RING + sp * 2 * C::TILE + C::TILE);
        wg_commit();
        wg_wait<0>();
        keep(acc);
        keep(p);
        bar_arrive(empty_v + sp);
        wg_fence();
        product_s<C>(sc, qs, wg, ks);
        wg_commit();
        your_turn<C>(wg);
        wg_wait<0>();
        keep(sc);
        bar_arrive(empty_k + s);
        online_softmax(sc, m, l, corr, i * BN, row, row0, t, causal, tg);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
        pack_p(p, sc);
    }
    {
        const int sp = (n - 1) % ST;
        bar_wait(full_v + sp, ((n - 1) / ST) & 1);
        my_turn<C>(wg);
        wg_fence();
        product_pv<C>(acc, p, smem + C::RING + sp * 2 * C::TILE + C::TILE);
        wg_commit();
        if (wg == 0) your_turn<C>(wg);                // consumer 1's last turn is the last
        wg_wait<0>();
        keep(acc);
        keep(p);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int r = row + 8 * h;
        if (r >= t) continue;
        const float l_safe = fmaxf(l[h], 1e-30f);
        bf16* orow = o + ((size_t)bh * t + r) * D + 2 * tg;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                __floats2bfloat162_rn(acc[j][2 * h] / l_safe, acc[j][2 * h + 1] / l_safe);
        if (tg == 0) lse[(size_t)bh * t + r] = m[h] + logf(l_safe);
    }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int bh,
                   int t, float qscale, int causal, cudaStream_t stream) {
    using C = Cfg<D>;
    CUtensorMap m[3];
    if (!(make_map(&m[0], q, bh, t, D) && make_map(&m[1], k, bh, t, D) &&
          make_map(&m[2], v, bh, t, D)))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (t + C::BM - 1) / C::BM);
    flash_fwd_bf16_kernel<D><<<grid, C::NTHREADS, C::SMEM, stream>>>(m[0], m[1], m[2], o, lse,
                                                                    t, qscale, causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" int zoo_flash_attention_fwd_bf16(const __nv_bfloat16* q,
                                            const __nv_bfloat16* k,
                                            const __nv_bfloat16* v,
                                            __nv_bfloat16* o, float* lse,
                                            int bh, int t, int d, float qscale,
                                            int causal, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    switch (d) {
        case 64:
            return (int)launch<64>(q, k, v, o, lse, bh, t, qscale, causal, s);
        case 128:
            return (int)launch<128>(q, k, v, o, lse, bh, t, qscale, causal, s);
        case 192:
            return (int)launch<192>(q, k, v, o, lse, bh, t, qscale, causal, s);
        case 256:
            return (int)launch<256>(q, k, v, o, lse, bh, t, qscale, causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
