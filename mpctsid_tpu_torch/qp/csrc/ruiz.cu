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
// is shared) and write Pb and Ab: at the MPC shape 2.2 GB at B = 4096, 0.66
// ms at 3.35 TB/s; the maxima are some 60 k operations a round a scenario.
//
// Design (first): a block per scenario, G = 4 row groups of W threads (W =
// n rounded up to a warp, at most 256: one a column).  P sits in shared
// memory where its n^2 floats fit beside the scales (n = 192: 147 KB of
// the 185 KB a block takes; `ruiz_layout` in qp/kernels.py picks it),
// else it is read from device memory each pass.  A is read through its
// batch stride, so that a constraint matrix broadcast to every scenario
// (stride 0) stays in L2 and is never materialized.  The first round reads
// A whole: each thread takes its column's weighted maximum over its
// group's rows, and each row's maximum over the columns is one warp
// reduction (__reduce_max_sync on the bit patterns) and a shared atomicMax
// per warp; beside that it keeps each thread's nonzeros of A (4 a thread,
// where they fit beside P).  Where they all fit, as the MPC's pyramid rows
// do (at most 2 a thread), the later rounds read those lists, with a shared
// atomicMax per entry, instead of A: a zero adds nothing to a maximum, so
// the bits are the same.  A round's first pass over P is the last round's
// cost-scaling pass (the same D), kept.  The one sum (the mean column norm)
// is a fixed tree that the host twin repeats (ruiz.h).  The body is ruiz.h's
// `equilibrate`, shared with the CPU tests' g++ build.  At B = 4096 the
// MPC's P in and Pb, Ab out take 1.4 ms of a launch, the first round 0.9
// (scripts/probe_kernel_designs.py --kernels ruiz): one block a
// multiprocessor waits on each of its phases in turn.

// Launch: ruiz_launch(in, stride, out, B, n, m, iters, p_in_smem, slots,
// stream):
// in = P, q, A, l, u (each scenario's rows contiguous, `stride` elements
// apart; 0 for a broadcast), out = Pb, qb, Ab, lb, ub, D, E, c
// (contiguous).  Returns a cudaError_t (0 on success); launches on
// `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "ruiz.h"

namespace {

struct DevExec {
    template <class F>
    __device__ void units(int count, F f)
    {
        for (int u = threadIdx.x; u < count; u += blockDim.x) f(u);
    }
    __device__ int threads() const { return blockDim.x; }
    __device__ void sync() { __syncthreads(); }
    // every lane of a warp calls it for the same row
    __device__ void row_max(float* dst, float v, int jc)
    {
        const unsigned r = __reduce_max_sync(0xffffffffu, __float_as_uint(v));
        if ((jc & (ruiz::WARP - 1)) == 0)
            atomicMax(reinterpret_cast<unsigned*>(dst), r);
    }
    __device__ void atomic_max(float* dst, float v)
    {
        atomicMax(reinterpret_cast<unsigned*>(dst), __float_as_uint(v));
    }
    // the tree of ruiz::HostExec::block_sum; the total in thread 0
    __device__ float block_sum(const float* v, int n, float* scratch)
    {
        const int t = threadIdx.x, T = blockDim.x;
        float s = 0.0f;
        for (int j = t; j < n; j += T) s = s + v[j];
        for (int off = ruiz::WARP / 2; off > 0; off /= 2)
            s = s + __shfl_down_sync(0xffffffffu, s, off);
        if ((t & (ruiz::WARP - 1)) == 0) scratch[t / ruiz::WARP] = s;
        __syncthreads();
        float total = 0.0f;
        if (t == 0)
            for (int w = 0; w < T / ruiz::WARP; ++w)
                total = total + scratch[w];
        return total;
    }
};

__global__ void __launch_bounds__(ruiz::GROUPS * ruiz::MAX_WIDTH)
ruiz_kernel(const ruiz::Args a)
{
    extern __shared__ __align__(16) float smem[];
    DevExec ex;
    ruiz::equilibrate(ex, a, blockIdx.x, smem);
}

}  // namespace

extern "C" {

long long ruiz_smem_floats(int n, int m, int p_in_smem, int slots)
{
    return ruiz::smem_floats(n, m, p_in_smem != 0, slots);
}

int ruiz_threads(int n) { return ruiz::threads(n); }

int ruiz_launch(const void* const* in, const long long* stride,
                void* const* out, int B, int n, int m, int iters,
                int p_in_smem, int slots, void* stream)
{
    if (B < 1 || n < 1 || m < 1 || iters < 0 || slots < 0)
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
    a.p_in_smem = p_in_smem;
    a.slots = slots;
    const long long bytes =
        4 * ruiz::smem_floats(n, m, p_in_smem != 0, slots);
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ruiz_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ruiz_kernel<<<B, ruiz::threads(n), (size_t)bytes,
                  (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

const char* ruiz_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
