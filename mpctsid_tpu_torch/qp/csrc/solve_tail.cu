// The solve's tail stages as kernels — CUDA, sm_90a.
//
// Three entries over solve_tail.h (which says what each computes and
// how its bits relate to the plain versions in qp/admm.py):
//
//   kkt_blocks  K = P + sigma I + A' diag(rho) A over the blocks its caller
//               declares, and rho_vec, once per adapt round on the kernel
//               backends (the MPC's QP: `a_blocks=MPC_A_BLOCKS`).  Replaces
//               a dense torch.bmm over all m rows (96.6 GFLOP a round at
//               B = 4096, n = 192, m = 320) and the copies around it.
//               JAX counterpart: mpctsid_tpu/qp/admm.py:222-224 (XLA).
//   adapt_rho   the per-scenario rho between adapt rounds: one pass over P
//               and A (or A's blocks) where the plain chain is about 20
//               kernels.  JAX: mpctsid_tpu/qp/admm.py:329-342.
//   unscale     the epilogue of every solve on the kernel backends and of
//               the whole-solve kernels: about 18 kernels of the plain
//               chain in one launch.  JAX: mpctsid_tpu/qp/admm.py:199-207.
//
// What bounds each on this card: bytes.  kkt_blocks reads P and writes K
// (2 n^2 values a scenario, 604 MB each at B = 4096 for the MPC); adapt_rho
// and unscale read P once (and A, whole or its blocks) and write O(n + m).
//
// Design (first).  kkt_blocks: a thread a run of four consecutive entries
// of K (then an entry of rho_vec) over the whole batch, a grid-stride
// loop, its four loads of P in flight together; only the entries inside
// the blocks read A (r rows each).  adapt_rho and unscale: a block per
// scenario, its threads taking the units of each phase in turn (x and y
// staged in shared memory; a row of P, and of a dense A, split over 32
// units that read its consecutive entries, then summed (at the MPC's
// shape; a unit a row at the WBC's, `tail_layout`); a thread a block
// row of A or a column of A'; the inf-norms as 32 partial maxima each,
// then one thread; adapt_rho's sums in double).  A is read through its
// batch stride: the MPC's stride-0 constant is never copied.  float and
// double (the CPU tests' float64 runs; the port's solves on the card are
// float32).
//
// Launch: solve_tail_{kkt,adapt,unscale}_launch(dtype, in, stride, out,
// par, B, n, m, r, c, threads, blocks, lanes, stream): the arrays in
// solve_tail.h's In / Out / Par order, (r, c) the declared blocks or (0,
// 0), the geometry of qp/tail.py's layout functions (checked here: a
// multiple of 32 threads, at most 1024; blocks = B for adapt and unscale;
// lanes 1 or 32, the units a row of P, which kkt_blocks ignores).
// Returns a cudaError_t (0 on success); launches on `stream` and allocates
// nothing.

#include <cuda_runtime.h>

#include "solve_tail.h"

namespace {

// every entry of the batch over the grid
struct GridExec {
    __device__ long long first(long long) const
    {
        return (long long)blockIdx.x * blockDim.x + threadIdx.x;
    }
    __device__ long long next(long long u) const
    {
        return u + (long long)gridDim.x * blockDim.x;
    }
};

// one scenario's units over a block
struct BlockExec {
    __device__ long long first(long long) const { return threadIdx.x; }
    __device__ long long next(long long u) const { return u + blockDim.x; }
    __device__ void sync() const { __syncthreads(); }
};

template <typename T>
__global__ void __launch_bounds__(1024)
tail_kkt_kernel(const tail::KktArgs<T> a, const tail::Shape s, long long B)
{
    tail::kkt_blocks<T>(GridExec{}, a, s, B);
}

template <typename T>
__global__ void __launch_bounds__(1024)
tail_adapt_kernel(const tail::AdaptArgs<T> a, const tail::Shape s)
{
    extern __shared__ __align__(16) unsigned char smem[];
    tail::adapt_rho<T>(BlockExec{}, a, s, (long long)blockIdx.x,
                       reinterpret_cast<double*>(smem));
}

template <typename T>
__global__ void __launch_bounds__(1024)
tail_unscale_kernel(const tail::UnArgs<T> a, const tail::Shape s)
{
    extern __shared__ __align__(16) unsigned char smem[];
    tail::unscale<T>(BlockExec{}, a, s, (long long)blockIdx.x,
                     reinterpret_cast<T*>(smem));
}

bool bad_shape(int B, int n, int m, int r, int c, int threads, int blocks,
               int lanes)
{
    if (B < 1 || n < 1 || m < 0 || threads < 32 || threads > 1024
        || threads % 32 != 0 || blocks < 1
        || (lanes != 1 && lanes != tail::MAX_LANES))
        return true;
    if (r == 0 && c == 0) return false;
    // r x c blocks tiling (m, n)
    return r < 1 || c < 1 || m % r != 0 || n % c != 0 || m / r != n / c;
}

// a block a scenario, its shared memory smem_values of V
template <typename V, class Kernel, class A>
int launch_scenarios(Kernel kernel, const A& a, tail::Shape s, int B,
                     int threads, cudaStream_t stream)
{
    const long long smem = tail::smem_values(s.n, s.m, !s.blocks(), s.lanes)
                           * (long long)sizeof(V);
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, (size_t)smem, stream>>>(a, s);
    return (int)cudaGetLastError();
}

template <typename T>
int kkt(const void* const* in, const long long* stride, void* const* out,
        const double* par, int B, tail::Shape s, int threads, int blocks,
        cudaStream_t stream)
{
    if (!s.blocks()) return (int)cudaErrorInvalidValue;
    tail::KktArgs<T> a;
    tail::fill(a, in, stride, out, par);
    tail_kkt_kernel<T><<<blocks, threads, 0, stream>>>(a, s, (long long)B);
    return (int)cudaGetLastError();
}

template <typename T>
int adapt(const void* const* in, const long long* stride, void* const* out,
          const double* par, int B, tail::Shape s, int threads,
          cudaStream_t stream)
{
    tail::AdaptArgs<T> a;
    tail::fill(a, in, stride, out, par);
    return launch_scenarios<double>(tail_adapt_kernel<T>, a, s, B, threads,
                                    stream);
}

template <typename T>
int unscale(const void* const* in, const long long* stride, void* const* out,
            const double* par, int B, tail::Shape s, int threads,
            cudaStream_t stream)
{
    tail::UnArgs<T> a;
    tail::fill(a, in, stride, out, par);
    a.ok = static_cast<unsigned char*>(out[tail::UO_OK]);
    return launch_scenarios<T>(tail_unscale_kernel<T>, a, s, B, threads,
                               stream);
}

bool null_in(const void* const* p, int count)
{
    for (int k = 0; k < count; ++k)
        if (p[k] == nullptr) return true;
    return false;
}

}  // namespace

extern "C" {

// solve_tail.h's counts (qp/tail.py::LAYOUT)
int solve_tail_layout(int what) { return tail::layout(what); }

// values (floats or doubles) of a scenario's shared memory
long long solve_tail_smem_values(int n, int m, int dense, int lanes)
{
    return tail::smem_values(n, m, dense, lanes);
}

int solve_tail_kkt_launch(int dtype, const void* const* in,
                          const long long* stride, void* const* out,
                          const double* par, int B, int n, int m, int r,
                          int c, int threads, int blocks, int lanes,
                          void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks, lanes)
        || null_in(in, tail::KI_COUNT)
        || null_in((const void* const*)out, tail::KO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return kkt<float>(in, stride, out, par, B, s, threads, blocks,
                          (cudaStream_t)stream);
    if (dtype == 1)
        return kkt<double>(in, stride, out, par, B, s, threads, blocks,
                           (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

int solve_tail_adapt_launch(int dtype, const void* const* in,
                            const long long* stride, void* const* out,
                            const double* par, int B, int n, int m, int r,
                            int c, int threads, int blocks, int lanes,
                            void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks, lanes) || blocks != B
        || null_in(in, tail::AI_COUNT)
        || null_in((const void* const*)out, tail::AO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return adapt<float>(in, stride, out, par, B, s, threads,
                            (cudaStream_t)stream);
    if (dtype == 1)
        return adapt<double>(in, stride, out, par, B, s, threads,
                             (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

int solve_tail_unscale_launch(int dtype, const void* const* in,
                              const long long* stride, void* const* out,
                              const double* par, int B, int n, int m, int r,
                              int c, int threads, int blocks, int lanes,
                              void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks, lanes) || blocks != B
        || null_in(in, tail::UI_COUNT)
        || null_in((const void* const*)out, tail::UO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return unscale<float>(in, stride, out, par, B, s, threads,
                              (cudaStream_t)stream);
    if (dtype == 1)
        return unscale<double>(in, stride, out, par, B, s, threads,
                               (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* solve_tail_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
