// Tile code shared by the float32 flash-attention kernels past head_dim
// 256, on flash_tile.cuh's split TF32: flash_attention_wide.cu (the
// forward) and flash_attention_wide_bwd.cu (dQ and dK/dV); their cluster
// code is flash_wide_cluster.cuh.  A block owns at most MAX_NC chunks of
// 64 of the output's columns; the grid's z splits the columns into column
// blocks as even as whole chunks allow (my_chunks, grid).  Query tiles are 64 rows (4 warps of 16), key tiles 32 rows, and
// the scores are taken in 64-column chunks of d through a two-stage
// cp.async ring: a K or V chunk is split into hi (in place) and a lo plane
// as it lands (split_b), the q or dO fragments in registers (dots_chunk).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace flash_wide {

using namespace flash_tile;

constexpr int CH = 64;                  // columns of a chunk of d
constexpr int CS = CH + 4;              // padded row stride of a chunk tile, floats
constexpr int BM = 64;                  // rows of a query tile: 4 warps of 16
constexpr int BN = 32;                  // rows of a key tile
constexpr int NJ = BN / 8;              // m16n8 tiles across a key tile
constexpr int NTHREADS = 128;
constexpr int MAX_NC = 4;               // chunks of the output a block owns
constexpr int OS = MAX_NC * CH + 4;     // padded row stride of an output-column tile
constexpr int A_TILE = BM * CS;
constexpr int B_TILE = BN * CS;
constexpr int STAGE = A_TILE + 2 * B_TILE;  // a chunk; b chunk's hi part and lo plane
constexpr int RING = 2 * STAGE;

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
// the scores, in 8-wide steps of d in order (UNROLL of them unrolled); a
// plain (split here), b a split chunk (hi part and lo plane).  STEPS: each
// step's three products start from zero and the step's sum is added to x
// in float32; else the steps are one accumulator chain.  The tensor core
// rounds the sum it accumulates toward zero, so a chain drifts by a
// fraction of an ulp of x a product: over all of a forward's d, LSE then
// missed its 1e-5 on the H100 by 1.1-1.3 times at D = 768 and 2.1-3.5 times
// at 2048, O its tolerance by up to 2.8 times, where a step's own sum
// drifts by ulps of itself and the adds round to nearest (LSE at most 0.36
// of its tolerance, O 0.51).  Chained over a rank's at most 256 columns
// and added over the cluster, LSE still reached 0.72 of its tolerance at
// 2048: the forward's partials take per-step sums, the backward's (1e-4)
// one chain, as the narrow kernels do.
template <int UNROLL, bool STEPS>
__device__ __forceinline__ void dots_chunk(float x[NJ][4], const float* a, int ra,
                                           const float* bh, const float* bl, float mul,
                                           int g, int tg) {
#pragma unroll (UNROLL)
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
            if (STEPS) {
                float step[4] = {0.f, 0.f, 0.f, 0.f};
                mma3(step, ah, al, bh, bl, o, o + 4);
#pragma unroll
                for (int e = 0; e < 4; ++e) x[j][e] += step[e];
            } else {
                mma3(x[j], ah, al, bh, bl, o, o + 4);
            }
        }
    }
}

// The output columns a block owns: chunks [c0, c0 + nc) of d's n, the
// column blocks as even as whole chunks allow.
__device__ __forceinline__ void my_chunks(int d, int& c0, int& nc) {
    const int n = d / CH, z = blockIdx.z, nz = gridDim.z;
    c0 = z * n / nz;
    nc = (z + 1) * n / nz - c0;
}

__device__ __forceinline__ void zero_acc(float acc[MAX_NC][CH / 8][4]) {
#pragma unroll
    for (int c = 0; c < MAX_NC; ++c)
#pragma unroll
        for (int n = 0; n < CH / 8; ++n) acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.f;
}

inline bool takes(int d) { return d >= 320 && d <= 2048 && d % CH == 0; }

// rows / tile row tiles, bh slices, ceil(d / 256) column blocks
inline dim3 grid(int rows, int tile, int bh, int d) {
    const int n = d / CH;
    return dim3((rows + tile - 1) / tile, bh, (n + MAX_NC - 1) / MAX_NC);
}

}  // namespace flash_wide
