// Hopper (sm_90a) building blocks of the bf16 flash kernels (the forward,
// flash_attention_fwd_bf16.cu; the backward, flash_attention_bwd_bf16.cu):
// shared tiles in the 128-byte swizzled layout that TMA writes and wgmma
// reads, their matrix descriptors, TMA tile loads completed on mbarriers,
// and the warpgroup products wgmma.mma_async m64nNk16 (bf16 operands,
// float32 accumulation).
//
// Tiles.  A tile of R rows by D bf16 values is stored as D / 64 column
// blocks of R rows x 128 bytes (64 values a row), block c at c * R * 128
// bytes.  Inside a block, row r's 16-byte chunk j sits at r * 128 +
// 16 * (j ^ (r % 8)): TMA's CU_TENSOR_MAP_SWIZZLE_128B, which wgmma names
// as layout type 1.  Every block starts on a 1024-byte boundary, as the
// swizzle needs.  One TMA box is 64 values by 64 rows of one (batch*head)
// slice, read through a 3-D tensor map over (D, T, B*H): rows past T lie
// outside the map and land as zeros, so a ragged tile never reads the
// next head.
//
// Descriptors (PTX ISA, "matrix descriptor"): a start address, a leading
// byte offset (LBO) and a stride byte offset (SBO), all in 16-byte units.
//   K-major (the 16 values a step sums over are contiguous in a row; the
//   A and B operands of S = A B^T): reduction step kk starts at column
//   block kk / 4, byte (kk % 4) * 32 of the row; 8-row groups lie SBO =
//   1024 bytes apart; LBO is unused.
//   MN-major (B read transposed, the bf16 operand of O += P V, dQ = dS K,
//   dV = P^T dO, dK = dS^T (q*scale): the sum runs over the tile's rows):
//   step kk starts 16 rows down, at kk * 2048 bytes; 8-row groups lie
//   SBO = 1024 bytes apart, the next 64 output columns LBO = R * 128 bytes
//   on (the next column block).  A product wider than 128 columns (head_dim
//   192, 256) is taken as 128- and 64-column slices, a slice's descriptor
//   starting at its first column block (wgmma_rs).
//
// Fragments.  Of an m64nN float32 accumulator, warp w of the warpgroup
// holds rows 16w + g and 16w + g + 8 (g = lane / 4) and, for each 8-column
// block j, columns 8j + 2t, 8j + 2t + 1 (t = lane % 4): acc[j][0..1] on
// row 16w + g, acc[j][2..3] on row 16w + g + 8, mma.sync's m16n8 layout
// warp by warp.  A register A operand (64 rows by 16) is, warp by warp,
// mma.sync's m16n8k16 A fragment, so the accumulator blocks 2kk and
// 2kk + 1 packed to bf16 pairs are the A operand of reduction step kk: P
// and dS feed the next product from registers.
//
// wgmma runs asynchronously: its accumulator and A registers must not be
// touched between the instruction and the wgmma.wait_group that retires
// it.  keep() (CUTLASS's warpgroup_fence_operand) pins such registers at
// a point in program order, so the compiler neither reads an accumulator
// before the wait nor reuses an A register before it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_tile {

__device__ __forceinline__ uint32_t saddr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(saddr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void bar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(saddr(bar)) : "memory");
}

// arrive, and expect that many bytes of TMA traffic before the phase ends
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(saddr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint32_t bar_test(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done;
}

// Wait until the barrier's phase of this parity has completed.  A wait
// that outlasts ~2^34 clocks (~9 s) traps: a fault in the pipeline then
// ends the launch with an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = saddr(bar);
    if (bar_test(a, parity)) return;
    const long long start = clock64();
    while (!bar_test(a, parity))
        if (clock64() - start > (1LL << 34)) __trap();
}

// ---------------------------------------------------------------- proxies

// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among the `threads` threads that name barrier `id` (id > 0)
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// count this warp's threads at barrier `id` without waiting for it: the
// other side of a named_bar_sync of `threads` threads
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// -------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3, %4}], [%5];\n"
                 :: "r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                    "r"(c2), "r"(saddr(bar))
                 : "memory");
}

// Rows [row0, row0 + R) of slice bh into a swizzled R x D tile, 64 x 64
// boxes; completes R * D * 2 bytes on `bar`.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint8_t* tile, const CUtensorMap* map, int row0,
                                          int bh, uint64_t* bar) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
        for (int h = 0; h < R / 64; ++h)
            tma_load(tile + (c * R + 64 * h) * 128, map, 64 * c, row0 + 64 * h, bh, bar);
}

// ------------------------------------------------------------ descriptors

__device__ __forceinline__ uint64_t desc(const uint8_t* p, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows [row, row + 64) of an R-row tile (or all 64 rows
// of a streamed tile), reduction step kk (values 16kk .. 16kk + 15)
template <int R>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int row, int kk) {
    return desc(tile + ((kk / 4) * R + row) * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major B operand: rows 16kk .. 16kk + 15 of an R-row tile as the
// reduction, its D columns as the output columns
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
    return desc(tile + kk * 2048, R * 128, 1024);
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int J>
__device__ __forceinline__ void keep(float (&a)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(a[j][e]) :: "memory");
}

template <int K>
__device__ __forceinline__ void keep(uint32_t (&a)[K][4]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e]) :: "memory");
}

template <int K, int P>
__device__ __forceinline__ void keep(uint32_t (&a)[K][P][4]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][p][e]) :: "memory");
}

#define WG_ACC4(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
// 32 or 64 accumulator registers from 8-column block o of d on
#define WG_ACC32(d, o)                                                                  \
    WG_ACC4(d, o + 0), WG_ACC4(d, o + 1), WG_ACC4(d, o + 2), WG_ACC4(d, o + 3),          \
        WG_ACC4(d, o + 4), WG_ACC4(d, o + 5), WG_ACC4(d, o + 6), WG_ACC4(d, o + 7)
#define WG_ACC64(d, o)                                                                  \
    WG_ACC32(d, o), WG_ACC4(d, o + 8), WG_ACC4(d, o + 9), WG_ACC4(d, o + 10),            \
        WG_ACC4(d, o + 11), WG_ACC4(d, o + 12), WG_ACC4(d, o + 13), WG_ACC4(d, o + 14),  \
        WG_ACC4(d, o + 15)
#define WG_OUT4(d, j) "=f"(d[j][0]), "=f"(d[j][1]), "=f"(d[j][2]), "=f"(d[j][3])
#define WG_OUT64(d)                                                                     \
    WG_OUT4(d, 0), WG_OUT4(d, 1), WG_OUT4(d, 2), WG_OUT4(d, 3), WG_OUT4(d, 4),          \
        WG_OUT4(d, 5), WG_OUT4(d, 6), WG_OUT4(d, 7), WG_OUT4(d, 8), WG_OUT4(d, 9),      \
        WG_OUT4(d, 10), WG_OUT4(d, 11), WG_OUT4(d, 12), WG_OUT4(d, 13), WG_OUT4(d, 14), \
        WG_OUT4(d, 15)
#define WG_REGS32                                                                       \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_REGS64                                                                       \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
    "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64) (+)= A . B^T over one 16-value step, both operands K-major
// in shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t a, uint64_t b,
                                           int accumulate) {
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : WG_ACC32(d, 0)
                 : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) = A . B^T over the first 16-value step, both operands
// K-major in shared memory (B: 128 rows of a tile), then d += A . B^T over
// each later step (wgmma_ss128).  The first step does not read d, and says
// so ("=f"): the registers' old values need not live until it.
__device__ __forceinline__ void wgmma_ss128_first(float (&d)[16][4], uint64_t a, uint64_t b) {
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : WG_OUT64(d)
                 : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss128(float (&d)[16][4], uint64_t a, uint64_t b) {
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : WG_ACC64(d, 0)
                 : "l"(a), "l"(b), "r"(1));
}

// Columns [8 J0, 8 J0 + N) of d (64 x 8J) += A . B over one 16-value step:
// A (64 x 16 bf16) from registers, B an N-column slice read MN-major
template <int N, int J0, int J>
__device__ __forceinline__ void wgmma_rs_at(float (&d)[J][4], const uint32_t (&a)[4],
                                            uint64_t b) {
    static_assert((N == 64 || N == 128) && J0 + N / 8 <= J, "a 64- or 128-column slice");
    if constexpr (N == 64) {
        asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
                     ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                     : WG_ACC32(d, J0)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    } else {
        asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
                     ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                     : WG_ACC64(d, J0)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
}

// d (64 x N) += A . B over reduction step kk: A (64 x 16 bf16) from
// registers, B rows 16kk .. 16kk + 15 of an R-row tile read MN-major
// (transposed), its N columns the output's.  A wgmma here takes at most
// 128 columns: N = 192 or 256 is a 128-column slice (column blocks 0-1)
// and a 64- or 128-column one (from column block 2) on the same A
// registers.
template <int N, int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         const uint8_t* tile, int kk) {
    static_assert(N == 64 || N == 128 || N == 192 || N == 256, "head_dim 64, 128, 192 or 256");
    if constexpr (N <= 128) {
        wgmma_rs_at<N, 0>(d, a, desc_mn<R>(tile, kk));
    } else {
        wgmma_rs_at<128, 0>(d, a, desc_mn<R>(tile, kk));
        wgmma_rs_at<N - 128, 16>(d, a, desc_mn<R>(tile + 2 * R * 128, kk));
    }
}

#undef WG_ACC4
#undef WG_ACC32
#undef WG_ACC64
#undef WG_OUT4
#undef WG_OUT64
#undef WG_REGS32
#undef WG_REGS64

// --------------------------------------------------------------- host side

// A 3-D tensor map over a (bh, t, d) bf16 tensor, innermost first
// (d, t, bh), with 64 x 64 boxes in the 128-byte swizzle; rows past t read
// as zeros.  cuTensorMapEncodeTiled lives in libcuda, not in the
// runtime: it is taken through cudaGetDriverEntryPoint, so the library
// links no -lcuda.  Returns false where the map is refused (a base
// address off 16 bytes).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static const EncodeTiledFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
        return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<EncodeTiledFn>(p)
                   : nullptr;
    }();
    return fn;
}

inline bool make_map(CUtensorMap* map, const void* base, int bh, int t, int d) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
    const cuuint32_t box[3] = {64, 64, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                  strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgmma_tile
