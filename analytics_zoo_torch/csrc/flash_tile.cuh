// Tile code shared by the float32 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the cp.async ring's
// copies, the split-TF32 rounding, and the mma.sync.m16n8k8 TF32 tile
// products; then, at the end, the three-part bf16 split of a float32
// operand (bf16_parts) that the bfloat16 backward
// (flash_attention_bwd_bf16.cu, on wgmma_tile.cuh) takes.
//
// Every template here takes the kernel's tile configuration C, which
// names:
//   C::D         head dimension (64, 128, 192 or 256: the fragment loops
//                run over D/8 steps)
//   C::BM        rows of the block's own tile (16 a warp, or a pair of
//                warps where dQ or dK/dV splits its work)
//   C::BN        rows of each streamed tile (16 to 64)
//   C::NTHREADS  threads of a block (32 * BM / 16, twice that for a split
//                dQ or dK/dV)
//   C::NJ        BN / 8, the m16n8 tiles across a streamed tile
//   C::S         padded row stride of a shared tile, D + 4 floats
//
// Split TF32 (CUTLASS's OpMultiplyAddFastF32): each float32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), both rounded as
// cvt.rna.tf32.f32 rounds (nearest, ties away from zero, 10 mantissa
// bits), and each tile product a.b is taken by three mma.sync.m16n8k8 TF32
// instructions accumulating in float32: lo_a.hi_b + hi_a.lo_b first, then
// hi_a.hi_b.  The dropped lo_a.lo_b term is ~2^-22 of a product, so a
// product keeps about float32's accuracy.  cvt.rna.tf32.f32 itself compiles
// to ~5 SASS instructions (it screens NaN and Inf); for finite x the same
// rounding is an integer add of half a TF32 ulp and a mask, which tf32_rna
// does.  A B operand is read by every warp of the block, so a streamed tile
// is split once, as it lands (split_own: hi in place, lo in a plane
// beside it), and only the A operands are split in registers; where a
// kernel's shared memory has no room for a tile's lo plane, that tile
// stays plain and each warp splits its B fragments as it reads them
// (dots' RAW_B, accumulate's RAW_X), to the same parts.
//
// Fragment layout: lane (g, t) = (lane / 4, lane % 4) of an m16n8
// accumulator holds rows g, g+8 and columns 2t, 2t+1.  An m16n8k8 A
// fragment holds rows g, g+8 and k-columns t, t+4; a B fragment k-rows t,
// t+4 of column g.  Shared tiles are float32 with rows padded to D+4
// floats: fragment reads by (row g, column t) hit banks 4g+t, and by (row
// 2t, column g) banks 8t+g, so every 32-bit fragment read is free of bank
// conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tile {

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes when !in (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start copying rows [r0, r0 + ROWS) of a (t, D) slice into a padded tile;
// rows past t are zero-filled.  Every call gives a thread the same 16-byte
// chunks, so once its copies have landed it may rewrite its own chunks
// without a barrier (scale_own, split_own).
template <class C, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int t) {
    constexpr int CH = C::D / 4;                   // 16-byte chunks a row
    static_assert(ROWS * CH % C::NTHREADS == 0, "a tile is whole chunks a thread");
#pragma unroll
    for (int i = 0; i < ROWS * CH / C::NTHREADS; ++i) {
        const int idx = threadIdx.x + i * C::NTHREADS;
        const int r = idx / CH, c = (idx % CH) * 4;
        const bool in = r0 + r < t;
        cp_async16(dst + r * C::S + c, src + (size_t)(in ? r0 + r : 0) * C::D + c, in);
    }
}

// ---------------------------------------------------------- split TF32

// the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32 for
// finite x): add half an ulp of the 10-bit mantissa to the magnitude, clear
// the 13 bits below it
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value; x - hi is exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// Split this thread's own (landed) chunks of a streamed tile, times mul:
// hi in place, lo into the lo plane.
template <class C>
__device__ __forceinline__ void split_own(float* hi, float* lo, float mul) {
    constexpr int CH = C::D / 4;
#pragma unroll
    for (int i = 0; i < C::BN * CH / C::NTHREADS; ++i) {
        const int idx = threadIdx.x + i * C::NTHREADS;
        const int off = (idx / CH) * C::S + (idx % CH) * 4;
        const float4 x = *reinterpret_cast<const float4*>(hi + off);
        uint4 h, l;
        split(x.x * mul, h.x, l.x);
        split(x.y * mul, h.y, l.y);
        split(x.z * mul, h.z, l.z);
        split(x.w * mul, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
    }
}

// Scale this thread's own (landed) chunks of the block's own tile.
template <class C>
__device__ __forceinline__ void scale_own(float* dst, float mul) {
    constexpr int CH = C::D / 4;
#pragma unroll
    for (int i = 0; i < C::BM * CH / C::NTHREADS; ++i) {
        const int idx = threadIdx.x + i * C::NTHREADS;
        float4* p = reinterpret_cast<float4*>(dst + (idx / CH) * C::S + (idx % CH) * 4);
        float4 x = *p;
        x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
        *p = x;
    }
}

// ------------------------------------------------------- tile products

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], float b0, float b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
          "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// c += a.b in split TF32, the small terms first; b from a tile's hi part
// and lo plane at the same offsets
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     const float* bh, const float* bl, int o0, int o1) {
    const float h0 = bh[o0], h1 = bh[o1];
    mma(c, al, h0, h1);
    mma(c, ah, bl[o0], bl[o1]);
    mma(c, ah, h0, h1);
}

// mma3 with b a tile that was not split as it landed (a kernel whose
// shared memory has no room for its lo plane): b split here, into the
// hi and lo parts split_own would have stored, so the products are
// mma3's bit for bit
__device__ __forceinline__ void mma3_raw(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                         const float* b, int o0, int o1) {
    uint32_t h0, l0, h1, l1;
    split(b[o0], h0, l0);
    split(b[o1], h1, l1);
    mma(c, al, __uint_as_float(h0), __uint_as_float(h1));
    mma(c, ah, __uint_as_float(l0), __uint_as_float(l1));
    mma(c, ah, __uint_as_float(h0), __uint_as_float(h1));
}

// acc[j] = a[ra : ra+16, :D] . b[8j : 8j + 8, :D]^T for j < NJ: a 16 x 8NJ
// tile of row-by-row dot products over D, summed in 8-wide steps of d in
// order; a is plain float32 (split here), b a split streamed tile (RAW_B:
// a plain one, split as it is read, bl unused).  Lane (g, t) holds rows
// ra+g, ra+g+8 and columns 8j + 2t, +1.
template <class C, bool RAW_B = false>
__device__ __forceinline__ void dots(float acc[C::NJ][4], const float* a, int ra,
                                     const float* bh, const float* bl, int g, int t) {
    constexpr int S = C::S, NJ = C::NJ;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < C::D; d0 += 8) {
        const float* ap = a + (ra + g) * S + d0 + t;
        uint32_t ah[4], al[4];
        split(ap[0], ah[0], al[0]);
        split(ap[8 * S], ah[1], al[1]);
        split(ap[4], ah[2], al[2]);
        split(ap[8 * S + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int o = (8 * j + g) * S + d0 + t;
            if (RAW_B) mma3_raw(acc[j], ah, al, bh, o, o + 4);
            else mma3(acc[j], ah, al, bh, bl, o, o + 4);
        }
    }
}

// acc[n] += w . x[8kk : 8kk + 8, 8n : 8n + 8] summed over kk < NJ, for
// n < D/8, where w is a 16 x 8NJ tile held as dots() leaves it and x a
// split streamed tile.  Accumulator to A operand without a shuffle or a
// shared round trip: the k order inside an 8-wide step is free as long as
// A and B agree, so w's columns 2t, 2t+1 of each step serve as k-slots t,
// t+4, and x is read at rows 8kk + 2t and + 1 (RAW_X: x a plain tile,
// split as it is read, xl unused).
template <class C, bool RAW_X = false>
__device__ __forceinline__ void accumulate(float acc[C::D / 8][4], const float w[C::NJ][4],
                                           const float* xh, const float* xl, int g, int t) {
    constexpr int S = C::S, NJ = C::NJ;
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
        uint32_t ah[4], al[4];
        split(w[kk][0], ah[0], al[0]);   // row g,   k-slot t
        split(w[kk][2], ah[1], al[1]);   // row g+8, k-slot t
        split(w[kk][1], ah[2], al[2]);   // row g,   k-slot t+4
        split(w[kk][3], ah[3], al[3]);   // row g+8, k-slot t+4
        const int o = (8 * kk + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < C::D / 8; ++n) {
            if (RAW_X) mma3_raw(acc[n], ah, al, xh, o + 8 * n, o + S + 8 * n);
            else mma3(acc[n], ah, al, xh, xl, o + 8 * n, o + S + 8 * n);
        }
    }
}

// ============================================================== bfloat16
//
// A float32 operand (P and dS in the bf16 backward, which takes its
// products with wgmma: wgmma_tile.cuh) is split into three bf16 parts,
// x = hi + mid + lo, each the nearest bf16 of what is left; the residue is
// below 2^-24 of |x| (each part takes 8 more significant bits and halves
// the rest), so three bf16 products, smallest part first, take the product
// to float32's accuracy at the bf16 rate.  The parts fill the registers of
// a 16 x 16 bf16 A operand, two values a register (the lower k in the
// lower half), as the accumulator of two 8-column blocks side by side
// holds them.

using bf16 = __nv_bfloat16;

// The nearest bf16 of x0 and x1, then of what each leaves, PARTS times:
// register i of each part's A fragment.
template <int PARTS>
__device__ __forceinline__ void bf16_parts(uint32_t a[PARTS][4], int i, float x0, float x1) {
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        a[p][i] = *reinterpret_cast<const uint32_t*>(&h);
        if (p + 1 < PARTS) {
            const float2 f = __bfloat1622float2(h);
            x0 -= f.x;                             // exact: f is x rounded
            x1 -= f.y;
        }
    }
}

}  // namespace flash_tile
