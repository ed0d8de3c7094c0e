// Flash-attention backward, float32, for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_dq_kernel
//           and ::_flash_dkv_kernel (launched from _flash_vjp_bwd).
//
// Both kernels recompute, per (query row i, key row j) of one (batch*head)
// slice laid out (BH, T, D), the forward's probabilities from its saved
// log-sum-exp, in the forward kernel's order of operations:
//   s_ij  = (q_i * scale) . k_j         (q scaled in float32 first; the
//                                         dot summed over d in the same
//                                         order as flash_attention_fwd.cu,
//                                         so s matches the forward's bit
//                                         for bit; causal: s = -1e30 where
//                                         j > i, not -inf)
//   p_ij  = exp(s_ij - lse_i)
//   dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)     delta_i = rowsum(do_i * o_i), from
//                                         the caller (a PyTorch op, as the
//                                         reference leaves it to XLA)
// and then
//   dq_i = scale * sum_j ds_ij k_j                       (zoo_flash_attention_dq)
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij (scale*q_i) (zoo_flash_attention_dkv)
// summed in float32.
//
// What bounds them on the H100: at the training shape (8, 12, 512, 64),
// dQ does 6*B*H*T^2*D = 9.7 GFLOP and dK/dV 8*B*H*T^2*D = 12.9 GFLOP on
// ~75 MB of operands, so both are bound by arithmetic.  This first version
// uses float32 FMAs (67 TFLOP/s peak), not the tensor cores, as the
// forward kernel does.
//
// Design.  The TPU kernels lean on the sequential grid: dK/dV revisits the
// same output block across q blocks and accumulates into it.  Blocks of a
// CUDA grid run in no order, so here no output element is written by two
// blocks and nothing is accumulated with atomics:
//   dQ:    one block of 256 threads per (bh, 64-row q tile).  The q tile
//          (scaled) and its dO tile stay in shared memory; 64-row K and V
//          tiles stream through; dS goes through a shared tile and dq
//          accumulates in registers.  Causal rows stop at the diagonal tile.
//   dK/dV: one block per (bh, 64-row k tile).  The K and V tiles stay in
//          shared memory; the block loops over the q tiles itself (the
//          FA2 order), staging each q (scaled) and dO tile, and keeps dk
//          and dv in registers.  Causal blocks start at the diagonal tile:
//          q tiles wholly above it are skipped.
// Each thread owns a 4x4 patch of the 64x64 score tile (rows ty+16i, keys
// tx+16j) and a 4 x (D/16) patch of its output (rows ty+16i, columns
// 4tx + 64c + 0..3).  Rows padded by 4 floats in shared memory keep 16-byte
// reads of neighbouring rows in distinct banks.  Keys and queries past T
// in a ragged last tile get probability 0; rows past T are not written.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // k rows per tile
constexpr int NTHREADS = 256;  // 16 x 16
constexpr int SSTRIDE = BK + 4;

template <int D>
struct Smem {
    static constexpr int STRIDE = D + 4;
    // dQ: q, dO, K, V tiles + the dS tile
    static constexpr int DQ_BYTES =
        (4 * BQ * STRIDE + BQ * SSTRIDE) * (int)sizeof(float);
    // dK/dV: K, V, q, dO tiles + P^T and dS^T tiles + lse and delta rows
    static constexpr int DKV_BYTES =
        (4 * BQ * STRIDE + 2 * BK * SSTRIDE + 2 * BQ) * (int)sizeof(float);
};

// Stage rows [r0, r0 + 64) of a (t, D) slice into a padded shared tile,
// multiplied by `mul` (1 or the softmax scale); rows past t are zeros.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int r0, int t, float mul, bool scaled) {
    constexpr int STRIDE = D + 4;
    for (int idx = threadIdx.x; idx < BQ * (D / 4); idx += NTHREADS) {
        const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < t)
            val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
        if (scaled) {
            val.x *= mul; val.y *= mul; val.z *= mul; val.w *= mul;
        }
        *reinterpret_cast<float4*>(dst + r * STRIDE + c) = val;
    }
}

// out[i][j] = a[ra + 16i] . b[rb + 16j] over D, with the forward kernel's
// order of fused multiply-adds.
template <int D>
__device__ __forceinline__ void tile_dots(float out[4][4], const float* a, int ra,
                                          const float* b, int rb) {
    constexpr int STRIDE = D + 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            av[i] = *reinterpret_cast<const float4*>(a + (ra + 16 * i) * STRIDE + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(b + (rb + 16 * j) * STRIDE + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                out[i][j] = fmaf(av[i].x, bv[j].x, out[i][j]);
                out[i][j] = fmaf(av[i].y, bv[j].y, out[i][j]);
                out[i][j] = fmaf(av[i].z, bv[j].z, out[i][j]);
                out[i][j] = fmaf(av[i].w, bv[j].w, out[i][j]);
            }
    }
}

// acc[i][cols] += sum_k w[ty + 16i][k] * x[k][cols] over a 64-wide tile
// w (stride SSTRIDE) and a (64, D) tile x; cols = 4tx + 64c + 0..3.
template <int D>
__device__ __forceinline__ void tile_accumulate(float acc[4][(D / 64) * 4],
                                                const float* w, const float* x,
                                                int ty, int tx) {
    constexpr int STRIDE = D + 4;
    constexpr int C4 = D / 64;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
        float4 wa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            wa[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * SSTRIDE + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int c = 0; c < C4; ++c) {
                const float4 xb = *reinterpret_cast<const float4*>(
                    x + (kk + u) * STRIDE + 4 * tx + 64 * c);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = u == 0 ? wa[i].x : u == 1 ? wa[i].y
                                  : u == 2 ? wa[i].z : wa[i].w;
                    acc[i][4 * c + 0] = fmaf(p, xb.x, acc[i][4 * c + 0]);
                    acc[i][4 * c + 1] = fmaf(p, xb.y, acc[i][4 * c + 1]);
                    acc[i][4 * c + 2] = fmaf(p, xb.z, acc[i][4 * c + 2]);
                    acc[i][4 * c + 3] = fmaf(p, xb.w, acc[i][4 * c + 3]);
                }
            }
        }
    }
}

template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float acc[4][(D / 64) * 4],
                                           int r0, int t, float mul, int ty, int tx) {
    constexpr int C4 = D / 64;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row >= t) continue;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
            float4 out;
            out.x = acc[i][4 * c + 0] * mul;
            out.y = acc[i][4 * c + 1] * mul;
            out.z = acc[i][4 * c + 2] * mul;
            out.w = acc[i][4 * c + 3] * mul;
            *reinterpret_cast<float4*>(dst + (size_t)row * D + 4 * tx + 64 * c) = out;
        }
    }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int t, float scale, int causal) {
    constexpr int STRIDE = Smem<D>::STRIDE;
    constexpr int C4 = D / 64;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* qs = smem;
    float* dos = qs + BQ * STRIDE;
    float* ks = dos + BQ * STRIDE;
    float* vs = ks + BK * STRIDE;
    float* dss = vs + BK * STRIDE;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const size_t base = (size_t)bh * t * D;

    stage_tile<D>(qs, q + base, q0, t, scale, true);
    stage_tile<D>(dos, dout + base, q0, t, 1.f, false);
    float lse_r[4], delta_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        lse_r[i] = row < t ? lse[(size_t)bh * t + row] : 0.f;
        delta_r[i] = row < t ? delta[(size_t)bh * t + row] : 0.f;
    }

    float acc[4][C4 * 4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C4 * 4; ++c) acc[i][c] = 0.f;

    int n_k = (t + BK - 1) / BK;
    if (causal) {
        const int last = (q0 + BQ + BK - 1) / BK;   // tiles any row of this block sees
        n_k = n_k < last ? n_k : last;
    }

    for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // previous tile's readers are done with ks/vs/dss
        stage_tile<D>(ks, k + base, k0, t, 1.f, false);
        stage_tile<D>(vs, v + base, k0, t, 1.f, false);
        __syncthreads();

        float s[4][4], dp[4][4];
        tile_dots<D>(s, qs, ty, ks, tx);
        tile_dots<D>(dp, dos, ty, vs, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qrow = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kcol = k0 + tx + 16 * j;
                float sv = s[i][j];
                if (causal && kcol > qrow) sv = -1e30f;
                const float p = (kcol < t && qrow < t) ? expf(sv - lse_r[i]) : 0.f;
                dss[(ty + 16 * i) * SSTRIDE + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
            }
        }
        __syncthreads();
        tile_accumulate<D>(acc, dss, ks, ty, tx);
    }
    store_rows<D>(dq + base, acc, q0, t, scale, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int t,
                 float scale, int causal) {
    constexpr int STRIDE = Smem<D>::STRIDE;
    constexpr int C4 = D / 64;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* ks = smem;
    float* vs = ks + BK * STRIDE;
    float* qs = vs + BK * STRIDE;
    float* dos = qs + BQ * STRIDE;
    float* pt = dos + BQ * STRIDE;      // P^T: pt[key][query]
    float* dst = pt + BK * SSTRIDE;     // dS^T
    float* ls = dst + BK * SSTRIDE;     // lse of the q tile
    float* dl = ls + BQ;                // delta of the q tile

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * BK;
    const size_t base = (size_t)bh * t * D;

    stage_tile<D>(ks, k + base, k0, t, 1.f, false);
    stage_tile<D>(vs, v + base, k0, t, 1.f, false);

    float dk_acc[4][C4 * 4], dv_acc[4][C4 * 4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C4 * 4; ++c) {
            dk_acc[i][c] = 0.f;
            dv_acc[i][c] = 0.f;
        }

    const int n_q = (t + BQ - 1) / BQ;
    // causal: q tiles whose last row lies above this tile's first key see
    // none of its keys
    const int qt0 = causal ? k0 / BQ : 0;

    for (int qt = qt0; qt < n_q; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();   // previous tile's readers are done with qs/dos/pt/dst
        stage_tile<D>(qs, q + base, q0, t, scale, true);
        stage_tile<D>(dos, dout + base, q0, t, 1.f, false);
        if (tid < BQ) {
            const int row = q0 + tid;
            ls[tid] = row < t ? lse[(size_t)bh * t + row] : 0.f;
            dl[tid] = row < t ? delta[(size_t)bh * t + row] : 0.f;
        }
        __syncthreads();

        // this thread's patch: query rows ty+16i, key rows tx+16j
        float s[4][4], dp[4][4];
        tile_dots<D>(s, qs, ty, ks, tx);
        tile_dots<D>(dp, dos, ty, vs, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qi = ty + 16 * i;
            const int qrow = q0 + qi;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kj = tx + 16 * j;
                const int kcol = k0 + kj;
                float sv = s[i][j];
                if (causal && kcol > qrow) sv = -1e30f;
                const float p = (kcol < t && qrow < t) ? expf(sv - ls[qi]) : 0.f;
                pt[kj * SSTRIDE + qi] = p;
                dst[kj * SSTRIDE + qi] = p * (dp[i][j] - dl[qi]);
            }
        }
        __syncthreads();
        // key rows ty+16i: dv += P^T dO, dk += dS^T (scale*q)
        tile_accumulate<D>(dv_acc, pt, dos, ty, tx);
        tile_accumulate<D>(dk_acc, dst, qs, ty, tx);
    }
    store_rows<D>(dk + base, dk_acc, k0, t, 1.f, ty, tx);
    store_rows<D>(dv + base, dv_acc, k0, t, 1.f, ty, tx);
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int bh, int t, float scale, int causal,
                      cudaStream_t stream) {
    const int bytes = Smem<D>::DQ_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((t + BQ - 1) / BQ, bh);
    flash_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, dout, lse, delta,
                                                         dq, t, scale, causal);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int t, float scale,
                       int causal, cudaStream_t stream) {
    const int bytes = Smem<D>::DKV_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((t + BK - 1) / BK, bh);
    flash_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, dout, lse, delta,
                                                          dk, dv, t, scale, causal);
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
        default:
            return (int)cudaErrorInvalidValue;
    }
}
