// The cluster code shared by the float32 flash-attention kernels past
// head_dim 256 (flash_attention_wide.cu, the forward; flash_attention_wide
// _bwd.cu, dQ and dK/dV), on flash_wide_tile.cuh's tiles.  The z column
// blocks of a row tile form one thread block cluster (cluster dims (1, 1,
// z), launched with cudaLaunchKernelEx; z <= 8, the portable limit), and
// rank r of it owns the columns C_r (my_chunks).  Each rank takes the
// partial scores over its own columns only; the ranks then add the z
// partials of every position in rank order 0 ... z-1 through distributed
// shared memory (exchange), so every rank holds the same sums, bit for
// bit.  The forward exchanges one partial a key tile (S), the backward two
// (S and dP).
//
// A partial is a block's 64 x 32 tile of sums in the m16n8 accumulator
// layout: each warp's 16 rows, a lane's four values of an m16n8 tile as one
// float4 (lanes side by side: no bank conflict).  Cluster barriers are
// barrier.cluster.arrive.release / wait.acquire: a step puts the partials,
// then arrive + wait (every rank's are in place), reads (after a scatter's
// second arrive + wait), then arrives as done reading; the caller waits on
// that last phase before it writes the partials' room again, and once more
// before it exits, so no rank leaves while another may still read its
// shared memory.  Every thread of every block of the cluster reaches every
// barrier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "flash_wide_tile.cuh"

namespace flash_wide {

namespace cg = cooperative_groups;

constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_Z = 8;                // ranks of a cluster: 2048 / (MAX_NC * CH)
constexpr int PART = NWARPS * NJ * 32 * 4;  // one partial (S or dP) of a block, floats

// The two phases of the cluster barrier: arrive (release: this thread's
// shared-memory writes are visible to the cluster once all have arrived)
// and wait (acquire).  Every thread of every block of the cluster calls
// them, in turn.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Put this warp's partial x into the block's partial buffer, each lane's
// four values of a tile as one float4 (lanes side by side: no bank
// conflict).
__device__ __forceinline__ void put_partial(float* part, const float x[NJ][4]) {
    float4* mine = reinterpret_cast<float4*>(part) + (threadIdx.x >> 5) * NJ * 32 +
                   (threadIdx.x & 31);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mine[j * 32] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
}

// Rank r's copy of this block's shared-memory address p: p itself for
// this block's own rank (a local read), else through distributed shared
// memory.
template <class T>
__device__ __forceinline__ T* at_rank(T* p, int r, int rank) {
    return r == rank ? p : cg::this_cluster().map_shared_rank(p, r);
}

// x = the sum of the partials of the cluster's nz ranks at this lane's
// positions, added in rank order (rank 0's first): the same sum, bit for
// bit, in every rank.  Each rank's four float4 are loaded before the adds
// that take them.
__device__ __forceinline__ void cluster_sum(float x[NJ][4], const float* part, int nz,
                                            int rank) {
    const float4* mine = reinterpret_cast<const float4*>(part) + (threadIdx.x >> 5) * NJ * 32 +
                         (threadIdx.x & 31);
#pragma unroll
    for (int r = 0; r < MAX_Z; ++r) {
        if (r >= nz) break;
        const float4* theirs = at_rank(mine, r, rank);
        float4 y[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) y[j] = theirs[j * 32];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            if (r == 0) {
                x[j][0] = y[j].x; x[j][1] = y[j].y; x[j][2] = y[j].z; x[j][3] = y[j].w;
            } else {
                x[j][0] += y[j].x; x[j][1] += y[j].y; x[j][2] += y[j].z; x[j][3] += y[j].w;
            }
        }
    }
}

__device__ __forceinline__ void add4(float4& s, const float4& y) {
    s.x += y.x; s.y += y.y; s.z += y.z; s.w += y.w;
}

// Reduce: for each float4 of a buffer of NP partials that this rank owns,
// the nz ranks' partials added in rank order (rank 0's first), written
// over its own partial there (no other rank reads those); four ranks'
// loads in flight at a time.  Rank r of nz owns the float4 [ceil(r N /
// nz), ceil((r + 1) N / nz)), N = NP * PART / 4: the owner of float4 i is
// i * nz / N.  Collective over the block.
template <int NP>
__device__ __forceinline__ void cluster_reduce(float* part, int nz, int rank) {
    constexpr int PARTS4 = NP * PART / 4;
    float4* mine = reinterpret_cast<float4*>(part);
    const int lo = (rank * PARTS4 + nz - 1) / nz, hi = ((rank + 1) * PARTS4 + nz - 1) / nz;
    for (int i = lo + threadIdx.x; i < hi; i += NTHREADS) {
        float4 sum;
#pragma unroll
        for (int r0 = 0; r0 < MAX_Z; r0 += 4) {
            if (r0 >= nz) break;
            float4 y[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                if (r0 + r < nz) y[r] = at_rank(mine, r0 + r, rank)[i];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if (r0 + r >= nz) break;
                if (r0 + r == 0) sum = y[0];
                else add4(sum, y[r]);
            }
        }
        mine[i] = sum;
    }
}

// Gather: x = the sums at this lane's positions of partial `at` / (PART /
// 4) of a buffer of NP (the first: at = 0, the second: at = PART / 4),
// each from the rank that owns it.
template <int NP>
__device__ __forceinline__ void cluster_gather(float x[NJ][4], float* part, int at, int nz,
                                               int rank) {
    constexpr int PARTS4 = NP * PART / 4;
    float4* mine = reinterpret_cast<float4*>(part);
    const int i0 = at + (threadIdx.x >> 5) * NJ * 32 + (threadIdx.x & 31);
    float4 y[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int i = i0 + j * 32;
        y[j] = at_rank(mine, i * nz / PARTS4, rank)[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        x[j][0] = y[j].x; x[j][1] = y[j].y; x[j][2] = y[j].z; x[j][3] = y[j].w;
    }
}

// One step's exchange of NP partials (the forward's S; the backward's S
// and dP): put this warp's partials (p, then ds) into `part`, and once
// every rank's are in place take their sums, in rank order, into p (and
// ds) (live warps); then arrive as done reading.  The caller waits on that
// arrival before it writes `part` again.  SCATTER: each rank sums its
// share of the buffer and, after a second barrier, gathers the sums (each
// partial read once, each sum nz times: 2 (nz - 1) / nz of the buffer
// over distributed shared memory); else every rank sums every position
// itself (each partial read nz times: nz - 1 buffers), one barrier fewer.
// Each kernel has an instance of each and takes SCATTER for clusters of
// its own SCATTER_FROM ranks or more.
template <int NP, bool SCATTER>
__device__ __forceinline__ void exchange(float p[NJ][4], float ds[NJ][4], float* part, int nz,
                                         bool live) {
    static_assert(NP == 1 || NP == 2, "one partial or two");
    const int rank = (int)cg::this_cluster().block_rank();
    put_partial(part, p);
    if constexpr (NP == 2) put_partial(part + PART, ds);
    cluster_arrive();
    cluster_wait();
    if (SCATTER) {
        cluster_reduce<NP>(part, nz, rank);
        cluster_arrive();
        cluster_wait();
    }
    if (live) {
        if (SCATTER) {
            cluster_gather<NP>(p, part, 0, nz, rank);
            if constexpr (NP == 2) cluster_gather<NP>(ds, part, PART / 4, nz, rank);
        } else {
            cluster_sum(p, part, nz, rank);
            if constexpr (NP == 2) cluster_sum(ds, part + PART, nz, rank);
        }
    }
    cluster_arrive();
}

// ------------------------------------------------------------- launches

// a launch of `grid` with the z column blocks of each row tile as one
// cluster
inline cudaLaunchConfig_t cluster_config(dim3 grid, int bytes, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = grid.z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <class... KArgs, class... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int bytes, void* stream,
                   Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(grid, bytes, reinterpret_cast<cudaStream_t>(stream), &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// How many clusters of z blocks of `kernel` the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
template <class K>
cudaError_t max_clusters(K kernel, int bytes, int z, int* clusters) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(dim3(1, 1, z), bytes, nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
}

}  // namespace flash_wide
