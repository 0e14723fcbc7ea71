// The period head, and the period plan, in one launch — CUDA, sm_90a.
//
// period_head: cascade/engine.py::period_head for a batch: the foot
// positions, the SRB state, the lift-off select and the offset-free
// velocity integrator of a period boundary (period_head.h says what and
// how).  period_plan: cascade/engine.py::period_plan, the same and then the
// footstep horizon on the head's x_srb, v_used and feet (plan/csrc/
// planner.h's units) and the touchdown select: the boundary's head, plan
// and select in one launch a period.  One kernel body (period_head.h's
// `period_warp`, the plan a template flag), two entry points.  The JAX
// package has no Pallas kernel here: its cascade leaves these ops to XLA
// under `jax.jit` (mpctsid_tpu/cascade/engine.py:66, :175-201), and its host
// path runs them as eager device ops and numpy (mpctsid_tpu/host.py:269-290).
// Run op by op the plain PyTorch chain is about 170 kernels for the head
// (the LegKin chain, quat_to_rot, rot_to_rpy, two bmm, the stacks and the
// integrator) and 911 for the footsteps, each 1.3-1.9 us of a CUDA graph's
// replay at B = 1: the node count, not the arithmetic, is the stage's time.
//
// What bounds them on this card: bytes.  Per scenario the head reads 59
// values (q, v, the lift-off mask and positions, v_int, v_cmd) and writes
// 42, for about 700 operations (chip_smoke.py::period_head_bound_ms); the
// plan reads 12 more and two ints (touchdown, gait, phase) and writes 216
// more (the footsteps, the next touchdown, the touchdown points).  Neither
// comes near that: at a small batch each costs about a launch, and the
// plan's reason is to be one launch where the first designs were three
// (head, footsteps, select); at B = 4096 a warp's phases, the head's and
// then the footsteps', run one after another.
//
// Design: a warp per scenario, rbd::warps_per_block's number a block (the
// WBC build's layout; dyn/kernels.py::rbd_layout), each warp with its slot
// (rbd::head::HeadSlot: the plan's staging rows, the leg kinematics, x_srb,
// v_used, the feet and the next touchdown, 507 values; the head alone uses
// the same slot).  float and double.
//
// Launch: period_head_launch / period_plan_launch(dtype, B, consts, in,
// stride, out, par, stream) with the arrays in period_head.h's In / Out /
// Par order (the plan's PlanIn / PlanOut / PlanPar after them); dtype 0
// float, 1 double.  Returns a cudaError_t (0 on success); launches on
// `stream` and allocates nothing.

#include <cuda_runtime.h>

#include "period_head.h"

namespace {

// warp w of the block takes scenario b, its slot at w * slot bytes
template <bool PLAN, typename T>
__device__ __forceinline__ void period_body(const T* __restrict__ consts,
                                            const rbd::head::HeadArgs<T>& a,
                                            const rbd::head::PlanArgs<T>& p,
                                            int B, int slot)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / rbd::WARP;
    const long long b =
        (long long)blockIdx.x * (blockDim.x / rbd::WARP) + warp;
    if (b >= B) return;
    rbd::WarpExec ex;
    rbd::head::period_warp<PLAN, T>(
        ex, consts, a, p, b,
        *reinterpret_cast<rbd::head::HeadSlot<T>*>(
            smem + (size_t)warp * slot));
}

template <typename T>
__global__ void __launch_bounds__(rbd::WARP * rbd::MAX_WARPS)
period_head_kernel(const T* __restrict__ consts,
                   const rbd::head::HeadArgs<T> args, int B, int slot)
{
    period_body<false, T>(consts, args, rbd::head::PlanArgs<T>{}, B, slot);
}

template <typename T>
__global__ void __launch_bounds__(rbd::WARP * rbd::MAX_WARPS)
period_plan_kernel(const T* __restrict__ consts,
                   const rbd::head::HeadArgs<T> args,
                   const rbd::head::PlanArgs<T> plan, int B, int slot)
{
    period_body<true, T>(consts, args, plan, B, slot);
}

int last_layout[3];   // warps a block, blocks, shared bytes a block

bool aligned16(const void* p)
{
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <bool PLAN, typename T>
int launch(int B, const void* consts, const void* const* in,
           const long long* stride, void* const* out, const double* par,
           cudaStream_t stream)
{
    using namespace rbd::head;
    HeadArgs<T> a;
    for (int k = 0; k < HI_COUNT; ++k) {
        a.in[k] = static_cast<const T*>(in[k]);
        a.stride[k] = stride[k];
    }
    for (int k = 0; k < HO_COUNT; ++k) a.out[k] = static_cast<T*>(out[k]);
    for (int k = 0; k < HP_COUNT; ++k) a.par[k] = (T)par[k];
    PlanArgs<T> p{};
    if (PLAN) {
        const void* const* pin = in + HI_COUNT;
        const long long* pst = stride + HI_COUNT;
        p.touchdown = static_cast<const T*>(pin[PLI_TOUCHDOWN]);
        p.gait = static_cast<const int*>(pin[PLI_GAIT]);
        p.phase = static_cast<const int*>(pin[PLI_PHASE]);
        p.tables = static_cast<const int*>(pin[PLI_TABLES]);
        p.td_stride = pst[PLI_TOUCHDOWN];
        p.gait_stride = pst[PLI_GAIT];
        p.phase_stride = pst[PLI_PHASE];
        for (int k = 0; k < PLO_COUNT; ++k)
            p.out[k] = static_cast<T*>(out[HO_COUNT + k]);
        const double* pp = par + HP_COUNT;
        p.N = (int)pp[PLP_N];
        for (int k = 0; k < planner::FP_COUNT; ++k)
            p.fp[k] = (T)pp[PLP_FOOT + k];
        if (p.N < 1) return (int)cudaErrorInvalidValue;
        if (!aligned16(p.out[PLO_FSTEPS]))
            return (int)cudaErrorMisalignedAddress;
    }
    int dev, optin, n_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const int slot = rbd::slot_bytes((int)sizeof(HeadSlot<T>));
    const int g = rbd::warps_per_block(B, slot, optin, n_sm);
    if (g < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + g - 1) / g, smem = g * slot;
    if (PLAN)
        period_plan_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>(
            static_cast<const T*>(consts), a, p, B, slot);
    else
        period_head_kernel<T><<<blocks, g * rbd::WARP, smem, stream>>>(
            static_cast<const T*>(consts), a, B, slot);
    last_layout[0] = g;
    last_layout[1] = blocks;
    last_layout[2] = smem;
    return (int)cudaGetLastError();
}

// the arrays' pointers (the head's, and the plan's after them where PLAN)
bool valid(int B, const void* consts, const void* const* in,
           void* const* out, bool plan)
{
    using namespace rbd::head;
    if (B < 1 || consts == nullptr) return false;
    for (int k = 0; k < HI_COUNT + (plan ? PLI_COUNT : 0); ++k)
        if (in[k] == nullptr) return false;
    for (int k = 0; k < HO_COUNT + (plan ? PLO_COUNT : 0); ++k)
        if (out[k] == nullptr) return false;
    return true;
}

template <bool PLAN>
int launch_dtype(int dtype, int B, const void* consts, const void* const* in,
                 const long long* stride, void* const* out,
                 const double* par, void* stream)
{
    if (!valid(B, consts, in, out, PLAN)) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<PLAN, float>(B, consts, in, stride, out, par,
                                   (cudaStream_t)stream);
    if (dtype == 1)
        return launch<PLAN, double>(B, consts, in, stride, out, par,
                                    (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// rbd.h's counts, then the head's and the plan's (dyn/kernels.py::LAYOUT,
// HEAD_LAYOUT)
int period_head_layout(int what) { return rbd::head::layout(what); }

// values (floats or doubles) of a warp's slot: rbd::head::HeadSlot
int period_head_slot_values()
{
    static_assert(sizeof(rbd::head::HeadSlot<double>)
                  == 2 * sizeof(rbd::head::HeadSlot<float>),
                  "slot of values");
    return (int)(sizeof(rbd::head::HeadSlot<float>) / sizeof(float));
}

// the last launch's (head or plan) warps a block (0), blocks (1), shared
// bytes a block (2)
int period_head_last_layout(int what)
{
    return what >= 0 && what < 3 ? last_layout[what] : -1;
}

int period_head_launch(int dtype, int B, const void* consts,
                       const void* const* in, const long long* stride,
                       void* const* out, const double* par, void* stream)
{
    return launch_dtype<false>(dtype, B, consts, in, stride, out, par,
                               stream);
}

int period_plan_launch(int dtype, int B, const void* consts,
                       const void* const* in, const long long* stride,
                       void* const* out, const double* par, void* stream)
{
    return launch_dtype<true>(dtype, B, consts, in, stride, out, par,
                              stream);
}

const char* period_head_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
