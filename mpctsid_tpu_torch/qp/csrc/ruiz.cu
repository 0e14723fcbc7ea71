// The Ruiz equilibration in one launch — CUDA, sm_90a.
//
// Computes qp/admm.py::ruiz_equilibrate for a batch: eight rounds of the
// norm-only modified Ruiz scaling of [[P, A'], [A, 0]] (the weighted column
// maxima of |P| and |A|, A's weighted row maxima, rsqrt with the 1e-10
// guard, the cost scale c from the mean column norm and max |q| D), then
// the scaled Pb, qb, Ab, lb, ub (infinite bounds kept) and D, E, c.  The
// kernel backends' scaled_solve takes it (qp/admm.py: m2, vpu, packed,
// mma); the plain backend keeps the plain chain.  The JAX package has no
// Pallas kernel here: under `jax.jit` XLA fuses each weighted product into
// its reduction (mpctsid_tpu/qp/admm.py:80, called at :209).  Op by op the
// plain PyTorch chain is about 291 kernels, and at B = 4096, n = 192,
// m = 320 it materializes |A| from the MPC's stride-0 constraint matrix
// (1.0 GB) and three weighted copies of |P| and |A| a round.
//
// What bounds it on this card: bytes.  It must read P (and A once where A
// is shared) and write Pb and Ab: at the MPC shape 2.2 GB at B = 4096, 0.67
// ms at 3.35 TB/s; the maxima are some 60 k operations a round a scenario.
//
// Design (second; the first, a block per scenario with all of P in shared
// memory, held one scenario a multiprocessor and ran its load, rounds and
// stores in turn: 4.7x its bound).  Two paths, `ruiz_layout` in
// qp/kernels.py picks one; the body of each is ruiz.h's, shared with the
// CPU tests' g++ build.
//
//   * ruiz_kernel_cluster (n > 32, or m > 64): a thread-block cluster of C
//     blocks per scenario, block r owning a slice of the columns.  Its
//     columns of P (74 KB at n = 192, C = 2) come in by one cp.async.bulk
//     per row, counted by an mbarrier, and leave scaled in place by bulk
//     stores, so that two to four blocks share a multiprocessor and one
//     scenario's loads and stores overlap another's rounds.  A round needs
//     two exchange steps across the cluster (st.async stores counted by an
//     mbarrier in the receiver, cluster_exchange.cuh; no cluster.sync()
//     inside the loop): the block's new D and its row maxima of A over its
//     columns, then its column norms and |q| D; every block forms the same
//     E and c from them.  A is read through its batch stride, so that a
//     constraint matrix broadcast to every scenario (stride 0) stays in L2
//     and is never materialized; the first round keeps each thread's
//     nonzeros of A and the later rounds read those lists where they all
//     fit (the MPC's pyramid rows).  A small batch takes a larger cluster
//     (up to 8), so that one scenario's rounds spread over several
//     multiprocessors.  Where a slice of P does not fit, it is read from
//     device memory each pass.
//   * ruiz_kernel_warp (n <= 32, m <= 64: the WBC's QPs): a warp per
//     scenario, several a block, lane j holding column j of P and of A in
//     registers, loaded row by row; D_i and E_i broadcast by shuffles, A's
//     row maxima through a tile of the warp's in shared memory (lane j
//     writes its column's |A_ij| D_j, lane i takes row i's maximum), the
//     mean's tree by shuffles; no block barrier.
//
// Launch: ruiz_launch(in, stride, out, B, n, m, iters, path, size,
// p_in_smem, slots, stream): in = P, q, A, l, u (each scenario's rows
// contiguous, `stride` elements apart; 0 for a broadcast), out = Pb, qb,
// Ab, lb, ub, D, E, c (contiguous); path 0 (warp: `size` scenarios a
// block) or 1 (cluster: `size` blocks a scenario).  Returns a cudaError_t
// (0 on success; ERR_UNSCHEDULABLE where the card holds no cluster of the
// layout); launches on `stream` and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"
#include "ruiz.h"

namespace cg = cooperative_groups;

namespace {

using namespace cluster_exchange;

constexpr int ERR_UNSCHEDULABLE = 100001;
constexpr unsigned FULL = 0xffffffffu;

// ruiz::equilibrate_cluster's executor: this block of the cluster
struct DevCluster {
    ruiz::Rank k;
    unsigned C;
    uint64_t* bars;
    bool bulk_in;

    template <class F>
    __device__ void each_rank(F f)
    {
        f(k);
    }
    template <class F>
    __device__ void units(int count, F f)
    {
        for (int u = threadIdx.x; u < count; u += blockDim.x) f(u);
    }
    __device__ void sync() { __syncthreads(); }
    __device__ void cluster_sync() { cg::this_cluster().sync(); }
    // every thread: until the step's bytes from every block are in
    __device__ void exchange(int bar, int it, unsigned bytes)
    {
        if (threadIdx.x == 0) barrier_expect(bars + bar, bytes);
        barrier_wait(bars + bar, (unsigned)(it & 1));
    }
    // every lane of a warp calls it for the same row
    __device__ void row_max(float* dst, float v, int jc)
    {
        const unsigned r = __reduce_max_sync(FULL, __float_as_uint(v));
        if ((jc & (ruiz::WARP - 1)) == 0)
            atomicMax(reinterpret_cast<unsigned*>(dst), r);
    }
    __device__ void atomic_max(float* dst, float v)
    {
        atomicMax(reinterpret_cast<unsigned*>(dst), __float_as_uint(v));
    }
    // dst[0, 4) (16-byte aligned) into every block of the cluster
    __device__ void send4_all(const ruiz::Rank&, float* dst, ruiz::F4 v,
                              int bar)
    {
        store4_all(C, dst, 0, make_float4(v.x, v.y, v.z, v.w), bars + bar);
    }
    // rows of `cols` floats -> shared memory: one cp.async.bulk a row where
    // both sides are 16-byte aligned, else plain loads (published by the
    // cluster barrier that follows)
    __device__ void load_rows(float* dst, int ld, const float* src,
                              int src_ld, int rows, int cols)
    {
        bulk_in = (cols & 3) == 0 && (src_ld & 3) == 0 && (ld & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(src) & 15) == 0;
        const int t = threadIdx.x, T = blockDim.x;
        if (bulk_in) {
            if (t == 0)
                barrier_expect(bars + ruiz::BAR_LOAD,
                               4u * (unsigned)rows * (unsigned)cols);
            if (cols > 0)
                for (int i = t; i < rows; i += T)
                    asm volatile(
                        "cp.async.bulk.shared::cluster.global.mbarrier::"
                        "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                        :: "r"(shared_addr(dst + (size_t)i * ld)),
                           "l"(src + (size_t)i * src_ld),
                           "r"(4u * (unsigned)cols),
                           "r"(shared_addr(bars + ruiz::BAR_LOAD))
                        : "memory");
        } else {
            for (int e = t; e < rows * cols; e += T) {
                const int i = e / cols, j = e - i * cols;
                dst[(size_t)i * ld + j] = src[(size_t)i * src_ld + j];
            }
        }
    }
    __device__ void wait_rows()
    {
        if (bulk_in) barrier_wait(bars + ruiz::BAR_LOAD, 0);
    }
    // shared memory -> rows of `cols` floats in device memory: one bulk
    // store a row where aligned, the source read before the block leaves
    __device__ void store_rows(float* dst, int dst_ld, const float* src,
                               int ld, int rows, int cols)
    {
        const bool bulk = (cols & 3) == 0 && (dst_ld & 3) == 0 &&
                          (ld & 3) == 0 &&
                          (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
        const int t = threadIdx.x, T = blockDim.x;
        // the threads' writes to `src` before the copy engine reads it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (bulk) {
            if (cols > 0 && t < rows) {
                for (int i = t; i < rows; i += T)
                    asm volatile(
                        "cp.async.bulk.global.shared::cta.bulk_group"
                        " [%0], [%1], %2;\n"
                        :: "l"(dst + (size_t)i * dst_ld),
                           "r"(shared_addr(src + (size_t)i * ld)),
                           "r"(4u * (unsigned)cols)
                        : "memory");
                asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
                asm volatile("cp.async.bulk.wait_group.read 0;\n"
                             ::: "memory");
            }
        } else {
            for (int e = t; e < rows * cols; e += T) {
                const int i = e / cols, j = e - i * cols;
                dst[(size_t)i * dst_ld + j] = src[(size_t)i * ld + j];
            }
        }
    }
    // ruiz::tree_sum of v and the maximum of q, in every thread: warp w
    // sums the tree's warp w (and takes its values' maximum of q) into
    // scratch[w] (scratch[32 + w]); after a block barrier every thread adds
    // the warps' sums in order
    __device__ void sum_and_max(const float* v, const float* q, int n,
                                float* scratch, float& sum, float& qmax)
    {
        const int T = ruiz::tree_threads(n), warps = ruiz::tree_warps(n);
        const int lane = threadIdx.x & 31;
        for (int w = threadIdx.x / ruiz::WARP; w < warps;
             w += blockDim.x / ruiz::WARP) {
            float s = 0.0f;
            unsigned mq = 0u;
            for (int j = w * ruiz::WARP + lane; j < n; j += T) {
                s = s + v[j];
                mq = max(mq, __float_as_uint(q[j]));
            }
            // lane 0's sums are the tree's (l + off = l ^ off below off)
            for (int off = ruiz::WARP / 2; off > 0; off /= 2)
                s = s + __shfl_xor_sync(FULL, s, off);
            mq = __reduce_max_sync(FULL, mq);
            if (lane == 0) {
                scratch[w] = s;
                scratch[ruiz::WARP + w] = __uint_as_float(mq);
            }
        }
        __syncthreads();
        float total = 0.0f, m = 0.0f;
        for (int w = 0; w < warps; ++w) {
            total = total + scratch[w];
            m = ruiz::mx(m, scratch[ruiz::WARP + w]);
        }
        sum = total;
        qmax = m;
    }
};

// ruiz::equilibrate_warp's executor: this lane of the scenario's warp
struct DevWarp {
    ruiz::Lane s;
    int lane;
    float* tile;      // the warp's [m][33] in shared memory

    __device__ void put(int i, int j, float v)
    {
        tile[i * ruiz::TILE_LD + j] = v;
    }
    // lane l reads row l of the tile: banks (l + j) % 32, no conflict
    __device__ float row_max(int i, int n) const
    {
        unsigned r = 0u;
        for (int j = 0; j < n; ++j)
            r = max(r, __float_as_uint(tile[i * ruiz::TILE_LD + j]));
        return __uint_as_float(r);
    }
    __device__ void sync_lanes() { __syncwarp(); }

    template <class F>
    __device__ void lanes(F f)
    {
        f(lane, s);
    }
    template <class G>
    __device__ float from(const ruiz::Lane& t, int src, G g)
    {
        return __shfl_sync(FULL, g(t), src);
    }
    template <class G>
    __device__ float max_of(const ruiz::Lane& t, G g)
    {
        return __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(g(t))));
    }
    // ruiz::tree_sum for n <= 32: one warp's tree from 0
    template <class G>
    __device__ float sum_of(const ruiz::Lane& t, int, G g)
    {
        float v = 0.0f + g(t);
        for (int off = ruiz::WARP / 2; off > 0; off /= 2)
            v = v + __shfl_xor_sync(FULL, v, off);
        return 0.0f + v;
    }
};

// two blocks a multiprocessor: up to 80 registers a thread
__global__ void __launch_bounds__(ruiz::GROUPS * ruiz::MAX_WIDTH, 2)
ruiz_kernel_cluster(const ruiz::Args a)
{
    extern __shared__ __align__(128) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    DevCluster ex;
    ex.C = cluster.num_blocks();
    ex.k.r = (int)cluster.block_rank();
    ex.k.s = smem;
    ex.k.c = 1.0f;
    ex.bars = reinterpret_cast<uint64_t*>(smem);
    ex.bulk_in = false;
    if (threadIdx.x == 0) {
        barrier_init(ex.bars + ruiz::BAR_LOAD);
        barrier_init(ex.bars + ruiz::BAR_SCALES);
        barrier_init(ex.bars + ruiz::BAR_NORMS);
        // visible to the other blocks' stores after the cluster barrier
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    ruiz::equilibrate_cluster(ex, a, blockIdx.x / ex.C);
}

__global__ void __launch_bounds__(ruiz::WARP * ruiz::MAX_WARPS)
ruiz_kernel_warp(const ruiz::Args a, int B)
{
    const long long b =
        (long long)blockIdx.x * (blockDim.x / ruiz::WARP) +
        threadIdx.x / ruiz::WARP;
    if (b >= B) return;
    extern __shared__ __align__(16) float tiles[];
    DevWarp ex;
    ex.lane = threadIdx.x & (ruiz::WARP - 1);
    ex.tile = tiles + (threadIdx.x / ruiz::WARP) * ruiz::WARP_TILE;
    ruiz::equilibrate_warp(ex, a, b);
}

bool valid(int path, int n, int m, int size)
{
    if (path == ruiz::PATH_WARP)
        return n <= ruiz::WARP_N && m <= ruiz::WARP_M && size >= 1 &&
               size <= ruiz::MAX_WARPS;
    return path == ruiz::PATH_CLUSTER && size >= 1 &&
           size <= ruiz::MAX_CLUSTER;
}

cudaError_t cluster_config(int B, int n, int m, int C, int p_in_smem,
                           int slots, void* stream,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* config)
{
    const size_t smem =
        4 * (size_t)ruiz::cluster_smem_floats(n, m, C, p_in_smem != 0, slots);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ruiz_kernel_cluster,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    *config = {};
    config->gridDim = dim3((unsigned)B * (unsigned)C, 1, 1);
    config->blockDim = dim3((unsigned)ruiz::cluster_threads(n, C), 1, 1);
    config->dynamicSmemBytes = smem;
    config->stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config->attrs = attr;
    config->numAttrs = 1;
    return cudaSuccess;
}

}  // namespace

extern "C" {

// the cluster path's dynamic shared memory a block, in floats (0: warp)
long long ruiz_smem_floats(int path, int n, int m, int size, int p_in_smem,
                           int slots)
{
    if (path == ruiz::PATH_WARP) return 0;
    return ruiz::cluster_smem_floats(n, m, size, p_in_smem != 0, slots);
}

int ruiz_threads(int path, int n, int size)
{
    return path == ruiz::PATH_WARP ? ruiz::WARP * size
                                   : ruiz::cluster_threads(n, size);
}

// blocks of this layout a multiprocessor holds at once (the occupancy
// calculator's answer: registers, shared memory, threads), or minus the
// CUDA error code
int ruiz_blocks_per_sm(int path, int n, int m, int size, int p_in_smem,
                       int slots)
{
    if (!valid(path, n, m, size)) return -(int)cudaErrorInvalidValue;
    int blocks = 0;
    cudaError_t err;
    if (path == ruiz::PATH_WARP) {
        err = cudaFuncSetAttribute(
            ruiz_kernel_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
            4 * ruiz::WARP_TILE * size);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, ruiz_kernel_warp, ruiz::WARP * size,
                4 * ruiz::WARP_TILE * size);
    } else {
        cudaLaunchAttribute attr[1];
        cudaLaunchConfig_t config;
        err = cluster_config(1, n, m, size, p_in_smem, slots, nullptr, attr,
                             &config);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, ruiz_kernel_cluster, (int)config.blockDim.x,
                config.dynamicSmemBytes);
    }
    return err == cudaSuccess ? blocks : -(int)err;
}

int ruiz_launch(const void* const* in, const long long* stride,
                void* const* out, int B, int n, int m, int iters, int path,
                int size, int p_in_smem, int slots, void* stream)
{
    if (B < 1 || n < 1 || m < 1 || iters < 0 || slots < 0 ||
        !valid(path, n, m, size))
        return (int)cudaErrorInvalidValue;
    ruiz::Args a;
    for (int k = 0; k < ruiz::I_COUNT; ++k) {
        if (in[k] == nullptr) return (int)cudaErrorInvalidValue;
        a.in[k] = static_cast<const float*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < ruiz::O_COUNT; ++k) {
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
        a.out[k] = static_cast<float*>(out[k]);
    }
    a.n = n;
    a.m = m;
    a.iters = iters;
    a.cluster = path == ruiz::PATH_CLUSTER ? size : 1;
    a.p_in_smem = p_in_smem;
    a.slots = slots;
    if (path == ruiz::PATH_WARP) {
        const int blocks = (B + size - 1) / size;
        const int smem = 4 * ruiz::WARP_TILE * size;
        const cudaError_t err = cudaFuncSetAttribute(
            ruiz_kernel_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return (int)err;
        ruiz_kernel_warp<<<blocks, ruiz::WARP * size, smem,
                           (cudaStream_t)stream>>>(a, B);
        return (int)cudaGetLastError();
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config;
    cudaError_t err = cluster_config(B, n, m, size, p_in_smem, slots, stream,
                                     attr, &config);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)ruiz_kernel_cluster,
                                         &config);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return ERR_UNSCHEDULABLE;
    err = cudaLaunchKernelEx(&config, ruiz_kernel_cluster, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* ruiz_error_string(int code)
{
    if (code == ERR_UNSCHEDULABLE)
        return "the cluster cannot be scheduled: "
               "cudaOccupancyMaxActiveClusters reports 0 clusters of this "
               "size, block size and shared memory";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
