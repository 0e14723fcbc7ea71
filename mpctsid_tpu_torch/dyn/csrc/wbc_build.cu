// The WBC QP build in one launch — CUDA, sm_90a.
//
// Computes wbc/tsid.py::_build_wbc_qp's whole tuple (H, g, A, l, u, M, h,
// JcT) for a batch: the mass matrix (crba), the bias (rnea at qdd = 0), the
// foot positions, Jacobians and drifts, and the cost and constraint rows of
// the TSID QP.  The JAX package has no Pallas kernel here: it leaves this
// stage to XLA, which fuses each elementwise chain under `jax.jit`
// (mpctsid_tpu/wbc/tsid.py:69).  Run op by op the plain PyTorch chain is
// about 824 kernels a tick, and replayed from a CUDA graph at B = 1 each
// costs 1.3-1.9 us: the node count, not the arithmetic, is the stage's time.
//
// Design (first): one thread per scenario, blocks of 32; the per-scenario
// body is rbd::wbc_build_one (rbd.h, shared with the CPU tests' host
// harness), which computes the leg kinematics once and writes every output
// straight to device memory.  float and double (the contract's float64
// build, `exact_pin`).
//
// What bounds it on this card: bytes.  Per scenario the inputs are 0.1-0.3
// KB and the outputs 3,088 values (H 900, A 1,500, M 324, J 216, g, l, u,
// h): 12.4 KB in float32 against about 12 k operations that the build
// needs (chip_smoke.py::rbd_ops; these loops do about 31 k), about one
// operation a byte where the card's f32 balance is 20.  One thread per
// scenario writes its rows with strided stores and keeps its intermediates
// (M, J, the leg kinematics: about 1 K values) in local memory; at B = 1
// the launch is one thread's serial chain.
//
// Launch: wbc_build_launch(dtype, B, consts, in, stride, out, par, stream)
// with the arrays of rbd.h's WbcIn / WbcOut / WbcPar order; dtype 0 float,
// 1 double.  Returns a cudaError_t (0 on success); launches on `stream` and
// allocates nothing.

#include <cuda_runtime.h>

#include "rbd.h"

namespace {

constexpr int THREADS = 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
wbc_build_kernel(const T* __restrict__ consts, const rbd::WbcArgs<T> args,
                 int B)
{
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    rbd::wbc_build_one<T>(consts, args, b);
}

template <typename T>
int launch(int B, const void* consts, const void* const* in,
           const long long* stride, void* const* out, const double* par,
           cudaStream_t stream)
{
    rbd::WbcArgs<T> a;
    for (int k = 0; k < rbd::WI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < rbd::WO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < rbd::WP_COUNT; ++k) a.par[k] = (T)par[k];
    wbc_build_kernel<T><<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        static_cast<const T*>(consts), a, B);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wbc_build_layout(int what) { return rbd::layout(what); }

int wbc_build_launch(int dtype, int B, const void* consts,
                     const void* const* in, const long long* stride,
                     void* const* out, const double* par, void* stream)
{
    if (B < 1 || consts == nullptr) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::WI_COUNT; ++k)
        if (in[k] == nullptr && k != rbd::WI_EXTRA)
            return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::WO_COUNT; ++k)
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(B, consts, in, stride, out, par,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<double>(B, consts, in, stride, out, par,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* wbc_build_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
