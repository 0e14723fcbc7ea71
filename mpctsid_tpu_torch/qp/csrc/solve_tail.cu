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
// Design.  kkt_blocks: a block a tile of one scenario's K
// (qp/tail.py::kkt_layout: 128 threads, a tile of 128 x KKT_PIECES pieces
// of 16 bytes, 9 tiles a scenario at n = 192), the scenario and the tile
// from blockIdx in 32 bits.  Where P is 16-byte aligned the tile comes in
// by one bulk copy while the block forms the rho_vec rows and block
// entries its tile meets (one phase, its loads of A, eqf and rho_s issued
// together), is patched in shared memory and leaves by one bulk store; a
// multiprocessor holds thirteen such tiles in flight without registers.
// Elsewhere a thread holds its pieces (a value each) in registers, loaded
// before the setup.  unscale at the WBC shape (n, m <= 64; `tail_layout`):
// a warp a scenario, as many a block as fit, their P and dense A in the
// warp's shared memory, a lane a row, the maxima by shuffles, no block
// barrier.  Where the rows are 16-byte aligned the warps are persistent,
// at most a block a multiprocessor: each walks its scenarios with two
// slots, the next scenario's P and A arriving by bulk copy and its vector
// inputs in registers while it works on the current one; elsewhere a
// warp takes one scenario and its lanes stage the rows.  unscale at the
// MPC shape: a block a scenario whose warps stream P in groups of
// ROW_GROUP rows (n = 192: 12 loads a lane issued together), the partials
// transposed at an odd stride, then two phases of partial maxima.
// adapt_rho takes the epilogue's two layouts (`adapt_layout`), its sums
// in double: at the WBC shape the persistent two-slot warps (or the
// staged one-slot warp), a lane a row of P and of A and a column of A',
// the seven inf-norms by shuffle trees; at the MPC shape a block a
// scenario (256 threads from B = 4 x 132 blocks, else 512) whose warps
// stream P's rows in groups, the seven inf-norms by shuffle trees in each
// warp and then one warp over the warps'.  The designs these replaced (a
// thread a run of four entries of K over the batch; a block a scenario
// for unscale and for adapt_rho, its units a row or a part of one, the
// maxima as 32 partials each and one thread's scan) and the candidates
// that did not ship live on as patched copies in
// scripts/probe_kernel_designs.py.  A is read through
// its batch stride: the MPC's stride-0 constant is never copied.  float
// and double (the CPU tests' float64 runs; the port's solves on the card
// are float32).
//
// Launch: solve_tail_{kkt,adapt,unscale}_launch(dtype, in, stride, out,
// par, B, n, m, r, c, threads, blocks, lanes, stream): the arrays in
// solve_tail.h's In / Out / Par order, (r, c) the declared blocks or (0,
// 0), the geometry of qp/tail.py's layout functions (checked here: a
// multiple of 32 threads, at most 1024; kkt: blocks = B x tiles and lanes
// the values a piece, 1 or 16 bytes' worth; adapt and unscale: lanes 1 or
// 2 the warp path's slots, threads / 32 scenarios a block, blocks = B
// over them (1 slot) or at most that (2); lanes 32 the block path, blocks
// = B).
// Returns a cudaError_t (0 on success); launches on `stream` and allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"
#include "solve_tail.h"

namespace {

using cluster_exchange::barrier_expect;
using cluster_exchange::barrier_init;
using cluster_exchange::barrier_wait;
using cluster_exchange::shared_addr;

constexpr unsigned FULL = 0xffffffffu;

// the geometry of each entry's last launch (kkt, adapt, unscale): threads,
// blocks, bytes of dynamic shared memory, lanes (solve_tail_last_layout)
long long g_last[3][4];

int launched(int entry, int threads, int blocks, long long smem, int lanes)
{
    const int err = (int)cudaGetLastError();
    if (err == 0) {
        g_last[entry][0] = threads;
        g_last[entry][1] = blocks;
        g_last[entry][2] = smem;
        g_last[entry][3] = lanes;
    }
    return err;
}

// one scenario's units over a block
struct BlockExec {
    __device__ long long first(long long) const { return threadIdx.x; }
    __device__ long long next(long long u) const { return u + blockDim.x; }
    __device__ void sync() const { __syncthreads(); }
    // adapt_rho's maxima: a unit a thread; the block's seven maxima, NaN-
    // propagating, by a shuffle tree in each warp, the warps' in `part`,
    // then one more in warp 0 (valid in warp 0)
    __device__ int width() const { return (int)blockDim.x; }
    __device__ void block_max(double* mx, double* part) const
    {
        const int lane = threadIdx.x % tail::WARP;
        const int warp = threadIdx.x / tail::WARP;
        const int warps = blockDim.x / tail::WARP;
        for (int w = 0; w < tail::MAXIMA; ++w) {
            for (int off = tail::WARP / 2; off > 0; off >>= 1)
                mx[w] = tail::nanmax(mx[w], __shfl_xor_sync(FULL, mx[w], off));
            if (lane == 0) part[warp * tail::MAXIMA + w] = mx[w];
        }
        __syncthreads();
        if (warp != 0) return;
        for (int w = 0; w < tail::MAXIMA; ++w) {
            mx[w] = lane < warps ? part[lane * tail::MAXIMA + w] : 0.0;
            for (int off = tail::WARP / 2; off > 0; off >>= 1)
                mx[w] = tail::nanmax(mx[w], __shfl_xor_sync(FULL, mx[w], off));
        }
    }
};

// a piece of V values: one 16-byte access, or V = 1 scalar ones; from
// device memory through the read-only path (`global`) or from shared
template <int V, bool global = true, typename T>
__device__ __forceinline__ void load_piece(const T* p, T* v)
{
    if constexpr (V * sizeof(T) == 16) {
        if constexpr (sizeof(T) == 4) {
            const float4 f =
                global ? __ldg(reinterpret_cast<const float4*>(p))
                       : *reinterpret_cast<const float4*>(p);
            v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
            const double2 f =
                global ? __ldg(reinterpret_cast<const double2*>(p))
                       : *reinterpret_cast<const double2*>(p);
            v[0] = f.x; v[1] = f.y;
        }
    } else {
        for (int t = 0; t < V; ++t) v[t] = global ? __ldg(p + t) : p[t];
    }
}

template <int V, typename T>
__device__ __forceinline__ void store_piece(T* p, const T* v)
{
    if constexpr (V * sizeof(T) == 16) {
        if constexpr (sizeof(T) == 4)
            *reinterpret_cast<float4*>(p) =
                make_float4(v[0], v[1], v[2], v[3]);
        else
            *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    } else {
        for (int t = 0; t < V; ++t) p[t] = v[t];
    }
}

// one scenario over a warp: this lane's state (tail::UnLane,
// tail::AdaptLane), its part of the maxima
template <class Lane>
struct WarpExec {
    Lane s;
    int lane;

    template <class F>
    __device__ void lanes(F f)
    {
        f(lane, s);
    }
    __device__ void sync() const { __syncwarp(); }
    template <class G>
    __device__ auto max_of(const Lane& t, G g) const
    {
        auto v = g(t);
        for (int off = tail::WARP / 2; off > 0; off >>= 1)
            v = tail::nanmax(v, __shfl_xor_sync(FULL, v, off));
        return v;
    }
    template <class G>
    __device__ bool all_of(const Lane& t, G g) const
    {
        return __all_sync(FULL, g(t)) != 0;
    }
};

// kkt_blocks where P is not 16-byte aligned: a thread's KKT_PIECES pieces
// of V values through its registers, their loads issued before the setup
template <typename T, int V>
__global__ void __launch_bounds__(1024)
tail_kkt_kernel(const tail::KktArgs<T> a, const tail::Shape s, int tiles)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;
    const int step = blockDim.x * V;
    const tail::KktTile tl = tail::kkt_tile(s, step * tail::KKT_PIECES, t);
    const T* P = a.row(tail::KI_P, b);
    T* K = a.out[tail::KO_K] + (long long)b * s.n * s.n;
    T v[tail::KKT_PIECES][V];
#pragma unroll
    for (int p = 0; p < tail::KKT_PIECES; ++p) {
        const int e = tl.e0 + p * step + threadIdx.x * V;
        if (e < tl.e1) load_piece<V>(P + e, v[p]);
    }
    T* sm = reinterpret_cast<T*>(smem);
    tail::kkt_setup(BlockExec{}, a, s, (long long)b, tl, sm);
#pragma unroll
    for (int p = 0; p < tail::KKT_PIECES; ++p) {
        const int e = tl.e0 + p * step + threadIdx.x * V;
        if (e < tl.e1) {
            tail::kkt_piece<V>(a, s, tl, sm, e, v[p]);
            store_piece<V>(K + e, v[p]);
        }
    }
}

// one bulk copy of `bytes` from device memory into this block's shared
// memory, counted by `bar`; one thread issues it
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(shared_addr(bar))
        : "memory");
}

// a barrier of this block's that bulk copies will count, before any copy
__device__ __forceinline__ void bulk_barrier_init(uint64_t* bar)
{
    barrier_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// kkt_blocks where P is 16-byte aligned: the tile comes in by one bulk
// copy into shared memory (thread 0 issues it, then the block forms the
// tile's setup), is patched there a piece of 16 bytes a thread at a time
// and leaves by one bulk store, so that a block holds no piece in
// registers and a multiprocessor keeps many tiles in flight
template <typename T>
__global__ void __launch_bounds__(1024)
tail_kkt_kernel_bulk(const tail::KktArgs<T> a, const tail::Shape s,
                     int tiles)
{
    constexpr int V = 16 / sizeof(T);
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;
    const int step = blockDim.x * V, tile = step * tail::KKT_PIECES;
    const tail::KktTile tl = tail::kkt_tile(s, tile, t);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    T* buf = reinterpret_cast<T*>(smem + 16);
    T* sm = buf + tile;
    const unsigned bytes = (unsigned)((tl.e1 - tl.e0) * sizeof(T));
    if (threadIdx.x == 0) {
        bulk_barrier_init(bar);
        barrier_expect(bar, bytes);
        bulk_load(buf, a.row(tail::KI_P, b) + tl.e0, bytes, bar);
    }
    tail::kkt_setup(BlockExec{}, a, s, (long long)b, tl, sm);
    barrier_wait(bar, 0);
#pragma unroll
    for (int p = 0; p < tail::KKT_PIECES; ++p) {
        const int e = tl.e0 + p * step + threadIdx.x * V;
        if (e < tl.e1) {
            T v[V];
            load_piece<V, false>(buf + (e - tl.e0), v);
            tail::kkt_piece<V>(a, s, tl, sm, e, v);
            store_piece<V>(buf + (e - tl.e0), v);
        }
    }
    // the threads' stores before the copy engine reads the tile
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                     " [%0], [%1], %2;\n"
                     :: "l"(a.out[tail::KO_K] + (long long)b * s.n * s.n
                            + tl.e0),
                        "r"(shared_addr(buf)), "r"(bytes)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
}

// adapt_rho's block path: a block a scenario
template <typename T>
__global__ void __launch_bounds__(1024)
tail_adapt_kernel_block(const tail::AdaptArgs<T> a, const tail::Shape s)
{
    extern __shared__ __align__(16) unsigned char smem[];
    tail::adapt_block<T>(BlockExec{}, a, s, (long long)blockIdx.x,
                         reinterpret_cast<double*>(smem));
}

template <typename T>
__global__ void __launch_bounds__(1024)
tail_unscale_kernel_block(const tail::UnArgs<T> a, const tail::Shape s)
{
    extern __shared__ __align__(16) unsigned char smem[];
    tail::unscale_block<T>(BlockExec{}, a, s, (long long)blockIdx.x,
                           reinterpret_cast<T*>(smem));
}

// the warp paths, one slot: a warp a scenario, its lanes staging P and a
// dense A through registers
template <typename T>
__global__ void __launch_bounds__(tail::MAX_WARPS * tail::WARP)
tail_unscale_kernel_warp(const tail::UnArgs<T> a, const tail::Shape s, int B)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int w = threadIdx.x / tail::WARP;
    const long long b = (long long)blockIdx.x * (blockDim.x / tail::WARP) + w;
    if (b >= B) return;
    WarpExec<tail::UnLane<T>> ex;
    ex.lane = threadIdx.x % tail::WARP;
    tail::unscale_warp<T>(
        ex, a, s, b,
        reinterpret_cast<T*>(
            smem + w * tail::warp_smem_bytes(s.n, s.m, !s.blocks(), 1,
                                             sizeof(T))));
}

template <typename T>
__global__ void __launch_bounds__(tail::MAX_WARPS * tail::WARP)
tail_adapt_kernel_warp(const tail::AdaptArgs<T> a, const tail::Shape s, int B)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int w = threadIdx.x / tail::WARP;
    const long long b = (long long)blockIdx.x * (blockDim.x / tail::WARP) + w;
    if (b >= B) return;
    WarpExec<tail::AdaptLane<T>> ex;
    ex.lane = threadIdx.x % tail::WARP;
    tail::adapt_warp<T>(ex, a, s, b,
                        smem + w * tail::adapt_warp_smem_bytes(
                                       s.n, s.m, !s.blocks(), 1, sizeof(T)));
}

// the warp paths, two slots: a persistent warp walks the scenarios b =
// first, first + stride, ...; lane 0 issues the bulk copies of the next
// scenario's P (P + b ps) and dense A (A + b as) into the slot the warp is
// not reading while it works on the current one, each slot's copies
// counted by its own mbarrier (phase k >> 1 of slot k & 1 at the warp's
// k-th scenario); `load(b, in)` the lane's inputs a scenario ahead, then
// `body(b, rows)` from the scenario's rows in shared memory (at `base + 16`
// after the two mbarriers, P's and A's at row stride n)
template <typename T, class In, class Load, class Body>
__device__ __forceinline__ void walk_scenarios(
    unsigned char* base, const T* P, long long ps, const T* A, long long as,
    int n, int m, bool dense, long long first, long long stride, int B,
    int lane, In& in, Load load, Body body)
{
    uint64_t* bars = reinterpret_cast<uint64_t*>(base);
    const long long slot = tail::slot_values(n, m, dense, n);
    T* slots = reinterpret_cast<T*>(base + 16);
    const unsigned pbytes = (unsigned)(n * n * sizeof(T));
    const unsigned abytes = dense ? (unsigned)(m * n * sizeof(T)) : 0u;
    load(first, in);
    auto issue = [&](long long b, int k) {
        T* dst = slots + k * slot;
        barrier_expect(bars + k, pbytes + abytes);
        bulk_load(dst, P + b * ps, pbytes, bars + k);
        if (abytes) bulk_load(dst + n * n, A + b * as, abytes, bars + k);
    };
    if (lane == 0) {
        bulk_barrier_init(bars);
        bulk_barrier_init(bars + 1);
        issue(first, 0);
    }
    __syncwarp();
    int k = 0;
    for (long long b = first; b < B; b += stride, ++k) {
        const int cur = k & 1;
        // the next scenario's rows by bulk copy, its inputs into
        // registers, both in flight while the warp works on this one
        In next = in;
        if (b + stride < B) {
            if (lane == 0) {
                // the warp's reads of that slot (its scenario before) are
                // done
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                issue(b + stride, cur ^ 1);
            }
            load(b + stride, next);
        }
        barrier_wait(bars + cur, (k >> 1) & 1);
        body(b, slots + cur * slot);
        in = next;
    }
}

template <typename T>
__global__ void __launch_bounds__(tail::MAX_WARPS * tail::WARP)
tail_unscale_kernel_warp_bulk(const tail::UnArgs<T> a, const tail::Shape s,
                              int B)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int n = s.n, m = s.m, dense = !s.blocks();
    const int w = threadIdx.x / tail::WARP, W = blockDim.x / tail::WARP;
    const long long first = (long long)blockIdx.x * W + w;
    if (first >= B) return;
    unsigned char* base =
        smem + w * tail::warp_smem_bytes(n, m, dense, 2, sizeof(T));
    T* xs = reinterpret_cast<T*>(base + 16)
            + 2 * tail::slot_values(n, m, dense, n);
    WarpExec<tail::UnLane<T>> ex;
    ex.lane = threadIdx.x % tail::WARP;
    walk_scenarios<T>(
        base, a.in[tail::UI_P], a.stride[tail::UI_P], a.in[tail::UI_A],
        a.stride[tail::UI_A], n, m, dense, first, (long long)gridDim.x * W,
        B, ex.lane, ex.s.in,
        [&](long long b, tail::LaneIn<T>& v) {
            tail::load_lane(v, a, s, b, ex.lane);
        },
        [&](long long b, const T* Ps) {
            tail::unscale_warp_rows(ex, a, s, b, Ps, Ps + n * n, n, xs,
                                    xs + n, [](int, tail::UnLane<T>&) {});
        });
}

template <typename T>
__global__ void __launch_bounds__(tail::MAX_WARPS * tail::WARP)
tail_adapt_kernel_warp_bulk(const tail::AdaptArgs<T> a, const tail::Shape s,
                            int B)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int n = s.n, m = s.m, dense = !s.blocks();
    const int w = threadIdx.x / tail::WARP, W = blockDim.x / tail::WARP;
    const long long first = (long long)blockIdx.x * W + w;
    if (first >= B) return;
    unsigned char* base =
        smem + w * tail::adapt_warp_smem_bytes(n, m, dense, 2, sizeof(T));
    double* xs = reinterpret_cast<double*>(
        base + tail::adapt_rows_bytes(n, m, dense, 2, sizeof(T)));
    WarpExec<tail::AdaptLane<T>> ex;
    ex.lane = threadIdx.x % tail::WARP;
    walk_scenarios<T>(
        base, a.in[tail::AI_P], a.stride[tail::AI_P], a.in[tail::AI_A],
        a.stride[tail::AI_A], n, m, dense, first, (long long)gridDim.x * W,
        B, ex.lane, ex.s.in,
        [&](long long b, tail::AdaptLaneIn<T>& v) {
            tail::load_adapt_lane(v, a, s, b, ex.lane);
        },
        [&](long long b, const T* Ps) {
            tail::adapt_warp_rows(ex, a, s, b, Ps, Ps + n * n, n, xs, xs + n,
                                  [](int, tail::AdaptLane<T>&) {});
        });
}

bool bad_shape(int B, int n, int m, int r, int c, int threads, int blocks)
{
    if (B < 1 || n < 1 || m < 0 || threads < 32 || threads > 1024
        || threads % 32 != 0 || blocks < 1)
        return true;
    if (r == 0 && c == 0) return false;
    // r x c blocks tiling (m, n)
    return r < 1 || c < 1 || m % r != 0 || n % c != 0 || m / r != n / c;
}

// `bytes` of dynamic shared memory for `kernel`, within the device's limit
template <class Kernel>
cudaError_t set_smem(Kernel kernel, long long bytes)
{
    int dev, optin;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (bytes > optin) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// a piece of V values is one 16-byte access only where P's rows, K and
// every scenario's first entry are 16-byte aligned
bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
int kkt(const void* const* in, const long long* stride, void* const* out,
        const double* par, int B, tail::Shape s, int threads, int blocks,
        int V, cudaStream_t stream)
{
    constexpr int V16 = 16 / (int)sizeof(T);
    if ((V != 1 && V != V16) || tail::kkt_bad(B, s, threads, blocks, V))
        return (int)cudaErrorInvalidValue;
    if (V > 1 && (!aligned16(in[tail::KI_P]) || !aligned16(out[tail::KO_K])
                  || stride[tail::KI_P] % V != 0))
        return (int)cudaErrorInvalidValue;
    tail::KktArgs<T> a;
    tail::fill(a, in, stride, out, par);
    const int tile = threads * tail::KKT_PIECES * V;
    const long long smem = tail::kkt_smem_bytes(s.n, s.c, tile, V > 1,
                                                (int)sizeof(T));
    const int tiles = blocks / B;
    cudaError_t err;
    if (V > 1) {
        err = set_smem(tail_kkt_kernel_bulk<T>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_kkt_kernel_bulk<T>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s, tiles);
    } else {
        err = set_smem(tail_kkt_kernel<T, 1>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_kkt_kernel<T, 1>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s, tiles);
    }
    return launched(0, threads, blocks, smem, V);
}

template <typename T>
int adapt(const void* const* in, const long long* stride, void* const* out,
          const double* par, int B, tail::Shape s, int threads, int blocks,
          cudaStream_t stream)
{
    if (tail::scenario_bad(B, s, threads, blocks))
        return (int)cudaErrorInvalidValue;
    const int dense = !s.blocks(), size = (int)sizeof(T);
    // the two-slot warp path's bulk copies need aligned rows
    if (s.lanes == 2
        && !tail::warp_bulk(in[tail::AI_P], stride[tail::AI_P],
                            in[tail::AI_A], stride[tail::AI_A], s, size))
        return (int)cudaErrorInvalidValue;
    tail::AdaptArgs<T> a;
    tail::fill(a, in, stride, out, par);
    const long long smem = tail::adapt_smem_bytes(
        s.n, s.m, dense,
        s.lanes == tail::MAX_LANES ? 0 : threads / tail::WARP, s.lanes, size);
    cudaError_t err;
    if (s.lanes == 1) {
        err = set_smem(tail_adapt_kernel_warp<T>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_adapt_kernel_warp<T>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s, B);
    } else if (s.lanes == 2) {
        err = set_smem(tail_adapt_kernel_warp_bulk<T>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_adapt_kernel_warp_bulk<T>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s, B);
    } else {
        err = set_smem(tail_adapt_kernel_block<T>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_adapt_kernel_block<T>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s);
    }
    return launched(1, threads, blocks, smem, s.lanes);
}

template <typename T>
int unscale(const void* const* in, const long long* stride, void* const* out,
            const double* par, int B, tail::Shape s, int threads, int blocks,
            cudaStream_t stream)
{
    if (tail::scenario_bad(B, s, threads, blocks))
        return (int)cudaErrorInvalidValue;
    const int dense = !s.blocks(), size = (int)sizeof(T);
    // the two-slot warp path's bulk copies need aligned rows
    if (s.lanes == 2
        && !tail::warp_bulk(in[tail::UI_P], stride[tail::UI_P],
                            in[tail::UI_A], stride[tail::UI_A], s, size))
        return (int)cudaErrorInvalidValue;
    tail::UnArgs<T> a;
    tail::fill(a, in, stride, out, par);
    a.ok = static_cast<unsigned char*>(out[tail::UO_OK]);
    const long long smem =
        s.lanes == tail::MAX_LANES
            ? tail::block_smem_values(s.n, s.m, dense) * size
            : (threads / tail::WARP)
                  * tail::warp_smem_bytes(s.n, s.m, dense, s.lanes, size);
    cudaError_t err;
    if (s.lanes == 1) {
        err = set_smem(tail_unscale_kernel_warp<T>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_unscale_kernel_warp<T>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s, B);
    } else if (s.lanes == 2) {
        err = set_smem(tail_unscale_kernel_warp_bulk<T>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_unscale_kernel_warp_bulk<T>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s, B);
    } else {
        err = set_smem(tail_unscale_kernel_block<T>, smem);
        if (err != cudaSuccess) return (int)err;
        tail_unscale_kernel_block<T>
            <<<blocks, threads, (size_t)smem, stream>>>(a, s);
    }
    return launched(2, threads, blocks, smem, s.lanes);
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

// bytes of a block's shared memory in adapt_rho: `warps` warps of `slots`
// slots on the warp path, or (warps 0) the block path; values of `size`
// bytes
long long solve_tail_adapt_smem_bytes(int n, int m, int dense, int warps,
                                      int slots, int size)
{
    return tail::adapt_smem_bytes(n, m, dense, warps, slots, size);
}

// bytes of a kkt_blocks block's shared memory (tiles of `tile` entries,
// values of `size` bytes; `bulk`: the tile's buffer and its barrier too)
long long solve_tail_kkt_smem_bytes(int n, int c, int tile, int bulk,
                                    int size)
{
    return tail::kkt_smem_bytes(n, c, tile, bulk, size);
}

// bytes of a block's shared memory in unscale: `warps` warps of `slots`
// slots on the warp path, or (warps 0) the block path; values of `size`
// bytes
long long solve_tail_unscale_smem_bytes(int n, int m, int dense, int warps,
                                        int slots, int size)
{
    return warps > 0
               ? warps * tail::warp_smem_bytes(n, m, dense, slots, size)
               : tail::block_smem_values(n, m, dense) * size;
}

// the last launch of `entry` (0 kkt, 1 adapt, 2 unscale): `what` 0
// threads, 1 blocks, 2 bytes of dynamic shared memory, 3 lanes
long long solve_tail_last_layout(int entry, int what)
{
    return entry >= 0 && entry < 3 && what >= 0 && what < 4
               ? g_last[entry][what] : -1;
}

int solve_tail_kkt_launch(int dtype, const void* const* in,
                          const long long* stride, void* const* out,
                          const double* par, int B, int n, int m, int r,
                          int c, int threads, int blocks, int lanes,
                          void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks)
        || null_in(in, tail::KI_COUNT)
        || null_in((const void* const*)out, tail::KO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, 1};
    if (dtype == 0)
        return kkt<float>(in, stride, out, par, B, s, threads, blocks, lanes,
                          (cudaStream_t)stream);
    if (dtype == 1)
        return kkt<double>(in, stride, out, par, B, s, threads, blocks,
                           lanes, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

int solve_tail_adapt_launch(int dtype, const void* const* in,
                            const long long* stride, void* const* out,
                            const double* par, int B, int n, int m, int r,
                            int c, int threads, int blocks, int lanes,
                            void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks)
        || null_in(in, tail::AI_COUNT)
        || null_in((const void* const*)out, tail::AO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return adapt<float>(in, stride, out, par, B, s, threads, blocks,
                            (cudaStream_t)stream);
    if (dtype == 1)
        return adapt<double>(in, stride, out, par, B, s, threads, blocks,
                             (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

int solve_tail_unscale_launch(int dtype, const void* const* in,
                              const long long* stride, void* const* out,
                              const double* par, int B, int n, int m, int r,
                              int c, int threads, int blocks, int lanes,
                              void* stream)
{
    if (bad_shape(B, n, m, r, c, threads, blocks)
        || null_in(in, tail::UI_COUNT)
        || null_in((const void* const*)out, tail::UO_COUNT))
        return (int)cudaErrorInvalidValue;
    const tail::Shape s{n, m, r, c, lanes};
    if (dtype == 0)
        return unscale<float>(in, stride, out, par, B, s, threads, blocks,
                              (cudaStream_t)stream);
    if (dtype == 1)
        return unscale<double>(in, stride, out, par, B, s, threads, blocks,
                               (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

const char* solve_tail_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
