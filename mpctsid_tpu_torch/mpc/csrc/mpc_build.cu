// The MPC QP build in one launch — CUDA, sm_90a.
//
// Computes mpc/srb.py::build_mpc_qp's (P, q, l, u) for a batch: the N
// one-step SRB models, the condensation over the horizon and the QP's cost
// and bound rows (its constraint matrix is a constant the wrapper hands
// back as a stride-0 view).  The JAX package has no Pallas kernel here: it
// leaves this stage to XLA under `jax.jit` (mpctsid_tpu/mpc/srb.py:120).
// Run op by op the plain PyTorch chain is about 196 kernels a call (16
// steps of three torch.bmm, the stacks, the dense Su' diag(Q) Su, the
// bound selects), each 1.3-1.9 us of a CUDA graph's replay at B = 1; at
// B = 4096 its dense P is 58 GFLOP and Su 604 MB of traffic.
//
// What bounds it on this card: bytes.  Over the horizon's structure
// (each A_k is I plus two 3 x 3 blocks, Su block lower-triangular, Q
// diagonal) a scenario needs about 1 MFLOP, and writes P: 147 KB in
// float32 (192 x 192), 604 MB at B = 4096, 0.19 ms at 3.35 TB/s.
//
// Design (first): a block of 384 threads per scenario, the body of
// mpc_build.h (shared with the CPU tests' host executor) in phases between
// __syncthreads(): the models (a thread a step and foot), Su's 136 blocks
// (a thread a column of B_j walking the horizon) and the drift, the
// backward recursion of S_j and g_j (16 steps of two phases: a thread an
// entry), then P: a thread a (row block, column), its column of W_j or of a
// Su block in registers, writing 12 rows, so a warp stores 32 consecutive
// values of a row.  Su, W, S and the drifts stay in dynamic shared memory
// (mpcb::smem_values(16) = 22,704 values: 91 KB in float32, two blocks a
// multiprocessor; 182 KB in float64, one).  No atomics, every sum in a
// fixed order: two launches agree bit for bit.  float and double (the
// contract's float64 condensation).
//
// Launch: mpc_build_launch(dtype, B, N, in, stride, out, par, stream) with
// the arrays in mpc_build.h's In / Out / Par order (the mass input may be
// null when PAR_HAS_MASS is 0); dtype 0 float, 1 double.  Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue when the shared memory
// of N does not fit the device); launches on `stream` and allocates
// nothing.

#include <cuda_runtime.h>

#include "mpc_build.h"

namespace {

struct BlockExec {
    __device__ int first(int) const { return (int)threadIdx.x; }
    __device__ int next(int u) const { return u + (int)blockDim.x; }
    __device__ void sync() const { __syncthreads(); }
};

template <typename T>
__global__ void __launch_bounds__(mpcb::THREADS)
mpc_build_kernel(const mpcb::Args<T> a, int N)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const BlockExec ex{};
    mpcb::build_scenario<T>(ex, a, N, (long long)blockIdx.x,
                            reinterpret_cast<T*>(smem));
}

template <typename T>
int launch(int B, int N, const void* const* in, const long long* stride,
           void* const* out, const double* par, cudaStream_t stream)
{
    mpcb::Args<T> a;
    mpcb::fill(a, in, stride, out, par);
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const long long smem = mpcb::smem_values(N) * (long long)sizeof(T);
    if (smem > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(mpc_build_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mpc_build_kernel<T><<<B, mpcb::THREADS, (size_t)smem, stream>>>(a, N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mpc_build.h's counts (mpc/kernels.py::LAYOUT)
int mpc_build_layout(int what) { return mpcb::layout(what); }

// values (floats or doubles) of a block's shared memory at horizon N
long long mpc_build_smem_values(int N) { return mpcb::smem_values(N); }

int mpc_build_launch(int dtype, int B, int N, const void* const* in,
                     const long long* stride, void* const* out,
                     const double* par, void* stream)
{
    if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < mpcb::IN_COUNT; ++k)
        if (in[k] == nullptr
            && (k != mpcb::IN_MASS || par[mpcb::PAR_HAS_MASS] != 0.0))
            return (int)cudaErrorInvalidValue;
    for (int k = 0; k < mpcb::OUT_COUNT; ++k)
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(B, N, in, stride, out, par,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<double>(B, N, in, stride, out, par,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* mpc_build_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
