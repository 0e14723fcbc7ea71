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
// Design: a pipelined block of 384 threads per scenario over mpc_build.h
// (shared with the CPU tests' host executor).  All 12 warps form the N
// models; then the block splits.  PRODUCER_WARPS (5) warps run the free
// response, the drift and the backward recursion (16 steps of two phases
// of 156 units, a unit a thread, between their own named barrier) and
// publish each W_j through an mbarrier of its own, never waiting for the
// others; the other 7 warps walk
// Su's columns (and write l, u) meanwhile, then stream P out behind the
// recursion: for j = N-1 ... 0 they wait for W_j and write row block j
// (12 rows, 9,216 contiguous bytes) as 4 x 4 tiles, a thread a tile, 16-
// byte loads of the operands from shared memory and 16-byte stores.  Su
// keeps rows 0:6 of each block and rows 6:12 of each B_i once (14,076
// values at N = 16: 56 KB in float32, four blocks a multiprocessor, the
// launch bounds holding registers to 40 a thread; 113 KB in float64, two).
// No atomics, every sum in a fixed order: two launches agree bit for bit,
// and P, q, l, u are the first design's bits (a block's phases one after
// another, P after the whole recursion; it lives on in
// scripts/probe_kernel_designs.py).  float and double (the contract's
// float64 condensation).
//
// Launch: mpc_build_launch(dtype, B, N, in, stride, out, par, stream) with
// the arrays in mpc_build.h's In / Out / Par order (the mass input may be
// null when PAR_HAS_MASS is 0); dtype 0 float, 1 double.  Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue when the shared memory
// of N does not fit the device or P is not 16-byte aligned); launches on
// `stream` and allocates nothing.  mpc_build_last_layout reports the last
// launch's geometry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpc_build.h"

namespace {

__device__ __forceinline__ uint32_t shared_addr(const void* ptr)
{
    return (uint32_t)__cvta_generic_to_shared(ptr);
}

// until phase 0 of the mbarrier completes (acquire: the producer's writes
// before its arrival are seen).  A count that never completes (a bug)
// ends the launch with an error instead of hanging it.
__device__ __forceinline__ void barrier_wait(uint64_t* bar)
{
    const uint32_t addr = shared_addr(bar);
#pragma unroll 1
    for (int spin = 0; spin < (1 << 22); ++spin) {
        uint32_t done;
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(addr), "r"(0u) : "memory");
        if (done) return;
    }
    __trap();
}

constexpr int PRODUCER_THREADS = 32 * mpcb::PRODUCER_WARPS;
constexpr int CONSUMER_THREADS = mpcb::THREADS - PRODUCER_THREADS;
static_assert(CONSUMER_THREADS >= 32 && CONSUMER_THREADS % 32 == 0,
              "the consumers are whole warps");

// the last launch: threads, blocks, bytes of dynamic shared memory, blocks
// a multiprocessor (the occupancy API's)
long long g_last[4];

// a block's units in turn (the models)
struct BlockExec {
    __device__ int first(int) const { return (int)threadIdx.x; }
    __device__ int next(int u) const { return u + (int)blockDim.x; }
};

// one group's units in turn: its own barrier (a named barrier, or the
// warp's for one warp), W_j's mbarriers
struct GroupExec {
    int tid;            // this thread in its group
    int count;          // the group's threads
    int bar;            // its named barrier
    uint64_t* bars;     // one a step

    __device__ int first(int) const { return tid; }
    __device__ int next(int u) const { return u + count; }
    __device__ void sync() const
    {
        if (count == 32)
            __syncwarp();
        else
            asm volatile("bar.sync %0, %1;\n" :: "r"(bar), "r"(count)
                         : "memory");
    }
    // the group's first thread, after the barrier that ends W_j's phase
    // (release: the consumers' wait sees every producer thread's part)
    __device__ void publish(int j) const
    {
        if (tid == 0)
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                         :: "r"(shared_addr(bars + j)) : "memory");
    }
    __device__ void await(int j) const { barrier_wait(bars + j); }
};

// the launch bounds' blocks a multiprocessor
template <typename T> struct MinBlocks {
    static constexpr int value = mpcb::MIN_BLOCKS_F32;
};
template <> struct MinBlocks<double> {
    static constexpr int value = mpcb::MIN_BLOCKS_F64;
};

template <typename T>
__global__ void __launch_bounds__(mpcb::THREADS, MinBlocks<T>::value)
mpc_build_kernel(const mpcb::Args<T> a, int N)
{
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    const mpcb::Smem<T> sm(
        reinterpret_cast<T*>(smem + mpcb::barrier_bytes(N)), N);
    const long long b = blockIdx.x;
    if (threadIdx.x == 0)
        for (int j = 0; j < N; ++j)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(shared_addr(bars + j)) : "memory");
    mpcb::model_phase(BlockExec{}, a, N, b, sm);
    __syncthreads();
    if ((int)threadIdx.x < PRODUCER_THREADS)
        mpcb::producer(GroupExec{(int)threadIdx.x, PRODUCER_THREADS, 1, bars},
                       a, N, b, sm);
    else
        mpcb::consumer(GroupExec{(int)threadIdx.x - PRODUCER_THREADS,
                                 CONSUMER_THREADS, 2, bars},
                       a, N, b, sm);
}

template <typename T>
int launch(int B, int N, const void* const* in, const long long* stride,
           void* const* out, const double* par, cudaStream_t stream)
{
    if ((uintptr_t)out[mpcb::OUT_P] % 16 != 0)
        return (int)cudaErrorInvalidValue;
    mpcb::Args<T> a;
    mpcb::fill(a, in, stride, out, par);
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const long long smem = mpcb::smem_bytes(N, (int)sizeof(T));
    if (smem > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(mpc_build_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    // blocks a multiprocessor, asked once for each size of shared memory
    static long long asked = -1;
    static int per_sm = 0;
    if (asked != smem) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mpc_build_kernel<T>, mpcb::THREADS, (size_t)smem);
        if (err != cudaSuccess) return (int)err;
        asked = smem;
    }
    mpc_build_kernel<T><<<B, mpcb::THREADS, (size_t)smem, stream>>>(a, N);
    err = cudaGetLastError();
    if (err == cudaSuccess) {
        g_last[0] = mpcb::THREADS;
        g_last[1] = B;
        g_last[2] = smem;
        g_last[3] = per_sm;
    }
    return (int)err;
}

}  // namespace

extern "C" {

// mpc_build.h's counts (mpc/kernels.py::LAYOUT)
int mpc_build_layout(int what) { return mpcb::layout(what); }

// values (floats or doubles) of a block's shared memory at horizon N, after
// mpcb::barrier_bytes(N) bytes of mbarriers
long long mpc_build_smem_values(int N) { return mpcb::smem_values(N); }

// the last launch: `what` 0 threads, 1 blocks, 2 bytes of dynamic shared
// memory, 3 blocks a multiprocessor
long long mpc_build_last_layout(int what)
{
    return what >= 0 && what < 4 ? g_last[what] : -1;
}

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
