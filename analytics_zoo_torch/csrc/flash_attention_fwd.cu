// Flash-attention forward, float32, for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py::_flash_kernel
//           (launched from _flash_fwd_impl).
//
// Computes, for each (batch*head) slice of q, k, v laid out (BH, T, D):
//   O   = softmax(scale * q k^T) v        (causal: keys after the query
//                                          masked to -1e30)
//   LSE = m + log(max(l, 1e-30))          per query row, float32
// with the reference's order of operations: q is multiplied by `scale`
// before the dot; an online softmax keeps the running max m and sum l in
// float32 across K/V tiles; causal rows stop at the last tile they see.
//
// What bounds it on the H100: at the serving shape (8, 12, 512, 64) it
// does 4*B*H*T^2*D = 6.4 GFLOP on 100 MB of q/k/v/o, so it is bound by
// arithmetic.  This first version uses float32 FMAs (67 TFLOP/s peak),
// not the tensor cores: the reference here is exact float32.
//
// Design: one block of 256 threads per (bh, 64-row q tile).  The q tile
// and each 64-row K and V tile are staged in shared memory (rows padded
// by 4 floats so that 16-byte reads of neighbouring rows fall in distinct
// banks).  Each thread owns a 4x4 patch of the 64x64 score tile (rows
// ty+16i, keys tx+16j), reduces row max and row sum across the 16
// threads of its half-warp with shuffles, writes its probabilities to a
// shared tile, and then accumulates a 4 x (D/16) patch of O (rows ty+16i,
// columns 4tx + 64c + 0..3) from that tile and V.  Keys past T in a
// ragged last tile get probability 0; rows past T are not written.
// No wgmma/TMA yet: moving to bf16/TF32 tensor cores is a later design.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per K/V tile
constexpr int NTHREADS = 256;  // 16 x 16
constexpr int SSTRIDE = BK + 4;

template <int D>
struct Smem {
    static constexpr int STRIDE = D + 4;
    static constexpr int BYTES =
        (3 * BQ * STRIDE + BQ * SSTRIDE) * (int)sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t, float scale, int causal) {
    constexpr int STRIDE = Smem<D>::STRIDE;
    constexpr int C4 = D / 64;   // float4 column groups per thread
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* qs = smem;
    float* ks = qs + BQ * STRIDE;
    float* vs = ks + BK * STRIDE;
    float* ps = vs + BK * STRIDE;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const size_t base = (size_t)bh * t * D;

    // stage q * scale (the reference scales q before the dot)
    for (int idx = tid; idx < BQ * (D / 4); idx += NTHREADS) {
        int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < t)
            val = *reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * D + c);
        val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
        *reinterpret_cast<float4*>(qs + r * STRIDE + c) = val;
    }

    float m[4], l[4], acc[4][C4 * 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -1e30f;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < C4 * 4; ++c) acc[i][c] = 0.f;
    }

    int n_k = (t + BK - 1) / BK;
    if (causal) {
        int last = (q0 + BQ + BK - 1) / BK;   // tiles any row of this block sees
        n_k = n_k < last ? n_k : last;
    }

    for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // previous tile's readers are done with ks/vs/ps
        for (int idx = tid; idx < BK * (D / 4); idx += NTHREADS) {
            int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (k0 + r < t) {
                size_t off = base + (size_t)(k0 + r) * D + c;
                kv = *reinterpret_cast<const float4*>(k + off);
                vv = *reinterpret_cast<const float4*>(v + off);
            }
            *reinterpret_cast<float4*>(ks + r * STRIDE + c) = kv;
            *reinterpret_cast<float4*>(vs + r * STRIDE + c) = vv;
        }
        __syncthreads();

        // scores: s[i][j] = q_scaled[ty+16i] . k[tx+16j]
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 qa[4], kb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * STRIDE + d);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * STRIDE + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
                    s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
                    s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
                    s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
                }
        }

        // online softmax per row
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qrow = q0 + ty + 16 * i;
            float mb = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kcol = k0 + tx + 16 * j;
                if (causal && kcol > qrow) s[i][j] = -1e30f;
                if (kcol < t) mb = fmaxf(mb, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
            const float m_new = fmaxf(m[i], mb);
            const float corr = expf(m[i] - m_new);
            float ls = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kcol = k0 + tx + 16 * j;
                const float p = kcol < t ? expf(s[i][j] - m_new) : 0.f;
                ps[(ty + 16 * i) * SSTRIDE + tx + 16 * j] = p;
                ls += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                ls += __shfl_xor_sync(0xffffffffu, ls, off);
            l[i] = l[i] * corr + ls;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < C4 * 4; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

        // acc[row][cols] += sum_k p[row][k] * v[k][cols]
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float4 pa[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * SSTRIDE + kk);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int c = 0; c < C4; ++c) {
                    const float4 vb = *reinterpret_cast<const float4*>(
                        vs + (kk + u) * STRIDE + 4 * tx + 64 * c);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                                      : u == 2 ? pa[i].z : pa[i].w;
                        acc[i][4 * c + 0] = fmaf(p, vb.x, acc[i][4 * c + 0]);
                        acc[i][4 * c + 1] = fmaf(p, vb.y, acc[i][4 * c + 1]);
                        acc[i][4 * c + 2] = fmaf(p, vb.z, acc[i][4 * c + 2]);
                        acc[i][4 * c + 3] = fmaf(p, vb.w, acc[i][4 * c + 3]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qrow = q0 + ty + 16 * i;
        if (qrow >= t) continue;
        const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < C4; ++c) {
            float4 out;
            out.x = acc[i][4 * c + 0] / l_safe;
            out.y = acc[i][4 * c + 1] / l_safe;
            out.z = acc[i][4 * c + 2] / l_safe;
            out.w = acc[i][4 * c + 3] / l_safe;
            *reinterpret_cast<float4*>(o + base + (size_t)qrow * D + 4 * tx + 64 * c) = out;
        }
        if (tx == 0) lse[(size_t)bh * t + qrow] = m[i] + logf(l_safe);
    }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int t, float scale, int causal,
                   cudaStream_t stream) {
    const int bytes = Smem<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((t + BQ - 1) / BQ, bh);
    flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, lse, t,
                                                          scale, causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" int zoo_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int bh, int t, int d, float scale,
                                       int causal, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (bh <= 0 || t <= 0) return (int)cudaSuccess;
    switch (d) {
        case 64:
            return (int)launch<64>(q, k, v, o, lse, bh, t, scale, causal, s);
        case 128:
            return (int)launch<128>(q, k, v, o, lse, bh, t, scale, causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
