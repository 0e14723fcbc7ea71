// The plant step in one launch — CUDA, sm_90a.
//
// Computes env/plant.py::plant_step for a batch: every substep's mass
// matrix (crba) and bias (rnea), foot positions and Jacobians, the penalty
// contact law with implicit damping (M + h J' D J) v+ = M v + h (tau - bias
// + J' f_el), the Coulomb-cone / unilateral clamp with anchor drag and the
// explicit re-solve where a foot was clamped, then the configuration's
// integration; both substeps in one launch.  The JAX package has no Pallas
// kernel here: XLA fuses the stage under `jax.jit` (mpctsid_tpu/env/
// plant.py:66, :131).  Op by op the plain PyTorch chain is about 2,339
// kernels a tick, each 1.3-1.9 us of a CUDA graph's replay at B = 1.
//
// Design (first): one thread per scenario, blocks of 32; the per-scenario
// body is rbd::plant_step_one (rbd.h, shared with the CPU tests' host
// harness).  The two 18 x 18 SPD solves of a substep go by an in-place
// Cholesky factor and two triangular solves, where the plain version forms
// inverses (qp/blockinv.py::spd_inverse); the second solve runs only where a
// foot was clamped.
//
// What bounds it on this card: operations, and far from the bound.  Per
// scenario the state and parameters are 66 values in (102 with the
// payload) and 61 out (0.5 KB in float32) against about 12.9 k operations
// that a substep needs (chip_smoke.py::rbd_ops: crba, rnea, J' D J, the
// factor and solves, with the model's zeros skipped).  These loops do
// about 30 k: dense 6 x 6 congruences, J' D J over every column with its
// row scale inside the sum, a dense 18 x 18 Cholesky.  One serial chain per
// thread in local memory; at B = 1 the launch is that one chain.
//
// Launch: plant_step_launch(dtype, B, consts, in, stride, out, par, stream)
// with the arrays of rbd.h's PlantIn / PlantOut / PlantPar order; dtype 0
// float, 1 double.  Returns a cudaError_t (0 on success); launches on
// `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "rbd.h"

namespace {

constexpr int THREADS = 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
plant_step_kernel(const T* __restrict__ consts, const rbd::PlantArgs<T> args,
                  int B)
{
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    rbd::plant_step_one<T>(consts, args, b);
}

template <typename T>
int launch(int B, const void* consts, const void* const* in,
           const long long* stride, void* const* out, const double* par,
           cudaStream_t stream)
{
    rbd::PlantArgs<T> a;
    for (int k = 0; k < rbd::PI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < rbd::PO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < rbd::PP_COUNT; ++k) a.par[k] = (T)par[k];
    plant_step_kernel<T><<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        static_cast<const T*>(consts), a, B);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int plant_step_layout(int what) { return rbd::layout(what); }

int plant_step_launch(int dtype, int B, const void* consts,
                      const void* const* in, const long long* stride,
                      void* const* out, const double* par, void* stream)
{
    if (B < 1 || consts == nullptr) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::PI_COUNT; ++k)
        if (in[k] == nullptr && k != rbd::PI_EXTRA)
            return (int)cudaErrorInvalidValue;
    for (int k = 0; k < rbd::PO_COUNT; ++k)
        if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(B, consts, in, stride, out, par,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<double>(B, consts, in, stride, out, par,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* plant_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
