// ADMM iteration with the refinement folded into one map M2 — CUDA, sm_90a.
//
// Replaces the TPU kernel `_admm_kernel_m2_packed` (reached through
// `admm_iterate_m2` / `admm_iterate_m2_packed_batch`) of
// mpctsid_tpu/qp/pallas_kernels.py.  Per scenario, `iters` times:
//
//     w   = rho * z - y
//     rhs = sigma * x - q + A' w
//     x_t = M2' rhs            (the TPU kernel reduces M2 * rhs_col over rows,
//                               i.e. applies M2 TRANSPOSED; M2 is symmetric
//                               only up to rounding, so the side is fixed)
//     z_t = A x_t
//     x   = alpha x_t + (1 - alpha) x
//     z_r = alpha z_t + (1 - alpha) z
//     z   = clip(z_r + y / rho, l, u)
//     y   = y + rho (z_r - z)
//
// and (x, z, y) are written out.  A is dense and generic, any n, m, B >= 1.
// f32 FMAs only (for a mat-vec with one useful column the tensor cores buy
// nothing: admm_mma.cu); the three mat-vecs are computed here, by this kernel.
//
// What bounds it.  The card's bound is operations: iters * (4 m n + 2 n^2)
// flops per scenario against the f32 FMA peak (chip_smoke.py computes it).
// The design before this one (one block per scenario, M2 in shared memory,
// A streamed from device memory / L2 twice per iteration) was bound by
// re-reading A: 60 GB per launch at the main path's shape.
//
// Design: a thread-block CLUSTER of C blocks per scenario, C the least of 1
// to 8 at which each block's row slices of M2 and A fit its shared memory
// beside its vectors (the wrapper's m2_layout(); 2 at n = 192, m = 320, 1 at
// the small shapes).  Block c owns rows I_c of M2 and rows R_c of A, loads
// them from device memory ONCE (A by cp.async into shared memory, M2 into
// registers, below) and keeps them for all iterations.  Per iteration:
//   1. p_c = A_{R_c}' w_{R_c}, a partial n-vector; the piece of it on the
//      rows I_o goes to block o (a reduce-scatter); every block sums the C
//      pieces of its rows in rank order and forms rhs on I_c;
//   2. s_c = M2_{I_c}' rhs_{I_c}, a partial n-vector, goes whole to every
//      block (an all-reduce); every block sums the C of them in rank order,
//      so all hold x_t bit for bit alike, and updates x;
//   3. z_t = A_{R_c} x_t and the z / y / w updates of the rows R_c: local.
// Two exchange steps per iteration, each an st.async store into the other
// block's shared memory counted by one mbarrier there
// (cluster_exchange.cuh), 16 bytes per store.  No cluster barrier inside the
// iteration.
// Products: f32 FMAs from shared memory, matrix rows read as 16-byte pieces
// and the vector operand as 16-byte broadcasts.  Transposed products (A' w,
// M2' rhs): a thread owns four neighbouring columns and a chunk of rows;
// chunks' partial sums meet in shared memory.  A x_t: a thread owns a row
// and a chunk of its columns; the row stride ld is 4 mod 8 floats, so the
// eight rows that a quarter warp reads lie on different banks.
// Where even a cluster of 8 cannot hold both slices, A is streamed from
// device memory every iteration (the earlier design's layout, coalesced:
// one warp per row of A x_t), and M2 too where it does not fit either.
// Each thread's part of M2 (12 rows of four columns) sits in REGISTERS
// (RES_M2_REGS) wherever the block's threads cover the slice that way, and
// only A in shared memory; otherwise M2's slice is in shared memory too.
//
// Measured (scripts/probe_kernel_designs.py; NVIDIA H100 80GB HBM3,
// 700.00 W; B = 4096, n = 192, m = 320, 30 iterations): 6.74 ms with M2 in
// registers and 384 threads per block (one part of M2 per thread; 480
// threads 6.98), 8.14 with M2 in shared memory, clusters of 3 10.3 and of 4
// 6.70 at 192 threads (0.8 % faster; not taken, PERF.md says why), one
// block per scenario with 64 of A's rows in shared memory and the rest
// streamed 16.1, against 24.27 for the design before.  The load is 0.70 ms,
// the three products about 4, the exchanges' waits 0.5.  PERF.md keeps the
// table.
//
// Plain C interface (loaded with ctypes): the launcher takes device pointers
// and the stream as integers, launches on that stream, allocates nothing,
// does not synchronise, and returns the CUDA error code of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cluster_exchange;

constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int MAX_THREADS = 512;
// `resident` bits: the slice of M2 in shared memory / of A in shared memory /
// M2's slice in registers (then not in shared memory)
constexpr int RES_M2 = 1, RES_A = 2, RES_M2_REGS = 4;
constexpr int REG_ROWS = 12;            // rows of M2 per thread in registers
constexpr int N_STEPS = 2;              // exchange steps per iteration
constexpr int BARRIER_FLOATS = 2 * N_STEPS;   // one 8-byte mbarrier each
// returned when the occupancy calculator finds no place for one cluster
constexpr int ERR_UNSCHEDULABLE = 100001;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ __forceinline__ int cdiv(int a, int b)
{
    return (a + b - 1) / b;
}

// Floats of one block's shared memory beside its matrix slices (the
// wrapper's m2_layout() computes the same): the barriers; x, q, x_t (whole);
// rhs on the block's rows of M2 (and REG_ROWS zeros past them, which the
// register variant's last chunk may read); z, y, w, l, u, rho, 1 / rho on
// its rows of A; partial sums of the products; the two exchange buffers (C
// slots of rows_n, C slots of the padded n).
__host__ __device__ __forceinline__ int m2_part_floats(int n, int rows_m,
                                                       int threads)
{
    const int np = round4(n), p = 4 * threads;
    const int q = np > rows_m ? np : rows_m;
    return p > q ? p : q;
}

__host__ __device__ __forceinline__ int m2_vec_floats(int n, int rows_n,
                                                      int rows_m, int C,
                                                      int threads)
{
    const int np = round4(n);
    return BARRIER_FLOATS + 3 * np + rows_n + REG_ROWS + 7 * rows_m
           + m2_part_floats(n, rows_m, threads) + C * (rows_n + np);
}

struct M2Args {
    const float *M2, *A, *q, *l, *u, *rho, *x0, *z0, *y0;
    float *x_out, *z_out, *y_out;
    int B, n, m, iters;
    float sigma, alpha;
};

__device__ __forceinline__ float4 f4(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float4 r, float v)
{
    acc.x = fmaf(r.x, v, acc.x);
    acc.y = fmaf(r.y, v, acc.y);
    acc.z = fmaf(r.z, v, acc.z);
    acc.w = fmaf(r.w, v, acc.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b)
{
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Transposed product by chunks: part[ch * np + j] = sum over the rows i of
// chunk ch (rows ch * L .. ch * L + L - 1, below `depth`) of
// mat[i * ld + j] * vec[i], for the `np` / 4 groups of four columns j.  A
// thread owns one (chunk, column group) unit at a time.  WIDE: 16-byte
// reads of the matrix (ld and the address multiples of four floats, the
// columns up to np readable); otherwise 4-byte reads, none past `cols`.
// `vec` is 16-byte aligned; L is a multiple of four.
template <bool WIDE>
__device__ __forceinline__ void matT_vec_chunks(
    const float* __restrict__ mat, int ld, int depth, int cols,
    const float* vec, float* part, int np, int chunks, int L)
{
    const int T = blockDim.x;
    const int cgs = np >> 2;
    for (int unit = threadIdx.x; unit < cgs * chunks; unit += T) {
        const int ch = unit / cgs;
        const int j = 4 * (unit - ch * cgs);
        const int i1 = min(depth, ch * L + L);
        float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
        int i = ch * L;
        if (WIDE) {
            const float* mp = mat + (size_t)i * ld + j;
            for (; i + 3 < i1; i += 4, mp += 4 * ld) {
                const float4 v = f4(vec + i);
                fma4(a0, f4(mp), v.x);
                fma4(a1, f4(mp + ld), v.y);
                fma4(a0, f4(mp + 2 * ld), v.z);
                fma4(a1, f4(mp + 3 * ld), v.w);
            }
            for (; i < i1; ++i, mp += ld) fma4(a0, f4(mp), vec[i]);
        } else {
            for (; i < i1; ++i) {
                const float* row = mat + (size_t)i * ld;
                const float v = vec[i];
                if (j < cols) a0.x = fmaf(row[j], v, a0.x);
                if (j + 1 < cols) a0.y = fmaf(row[j + 1], v, a0.y);
                if (j + 2 < cols) a0.z = fmaf(row[j + 2], v, a0.z);
                if (j + 3 < cols) a0.w = fmaf(row[j + 3], v, a0.w);
            }
        }
        *reinterpret_cast<float4*>(part + ch * np + j) = add4(a0, a1);
    }
}

// The same product with this thread's REG_ROWS rows of its four columns
// held in registers (`mr`, loaded once): chunk ch = t / (np / 4), rows
// ch * REG_ROWS ..; the wrapper guarantees one unit per thread.
__device__ __forceinline__ void matT_vec_regs(const float4 (&mr)[REG_ROWS],
                                              const float* vec, float* part,
                                              int np, int chunks)
{
    const int cgs = np >> 2;
    const int t = threadIdx.x;
    if (t >= cgs * chunks) return;
    const int ch = t / cgs;
    const int j = 4 * (t - ch * cgs);
    const float* v = vec + ch * REG_ROWS;
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
#pragma unroll
    for (int r = 0; r < REG_ROWS; r += 4) {
        const float4 vv = f4(v + r);
        fma4(a0, mr[r], vv.x);
        fma4(a1, mr[r + 1], vv.y);
        fma4(a0, mr[r + 2], vv.z);
        fma4(a1, mr[r + 3], vv.w);
    }
    *reinterpret_cast<float4*>(part + ch * np + j) = add4(a0, a1);
}

// Product as given by chunks of columns, the matrix in shared memory (rows
// of stride ld, a multiple of four, zero-padded): part[kc * rows + i] = sum
// over the columns k of chunk kc (KL of them, a multiple of four) of
// mat[i * ld + k] * vec[k]; a thread owns one (chunk, row) unit at a time,
// neighbouring threads neighbouring rows.
__device__ __forceinline__ void mat_vec_chunks(const float* mat, int ld,
                                               int rows, int np,
                                               const float* vec, float* part,
                                               int kch, int KL)
{
    const int T = blockDim.x;
    for (int unit = threadIdx.x; unit < rows * kch; unit += T) {
        const int kc = unit / rows;
        const int i = unit - kc * rows;
        const int k1 = min(np, kc * KL + KL);
        const float* row = mat + (size_t)i * ld;
        float a0 = 0.f, a1 = 0.f;
        for (int k = kc * KL; k < k1; k += 4) {
            const float4 r = f4(row + k);
            const float4 v = f4(vec + k);
            a0 = fmaf(r.x, v.x, a0);
            a1 = fmaf(r.y, v.y, a1);
            a0 = fmaf(r.z, v.z, a0);
            a1 = fmaf(r.w, v.w, a1);
        }
        part[kc * rows + i] = a0 + a1;
    }
}

// ... the matrix streamed from device memory (row stride ld): one warp per
// row, lanes on consecutive columns (coalesced), shuffle sum; part[i].
__device__ __forceinline__ void mat_vec_streamed(const float* __restrict__ mat,
                                                 int ld, int rows, int n,
                                                 const float* vec, float* part)
{
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < rows; i += n_warps) {
        const float* row = mat + (size_t)i * ld;
        float acc = 0.f;
        for (int k = lane; k < n; k += 32) acc = fmaf(row[k], vec[k], acc);
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) part[i] = acc;
    }
}

// sum of the `chunks` partial float4s at part[j], part[np + j], ...
__device__ __forceinline__ float4 sum_chunks4(const float* part, int np,
                                              int chunks, int j)
{
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < chunks; ++c) s = add4(s, f4(part + c * np + j));
    return s;
}

template <bool REGS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
admm_m2_cluster_kernel(M2Args a, int ld, int rows_n, int rows_m,
                       int resident)
{
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / C;
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int n = a.n, m = a.m;
    const int np = round4(n);
    const int cgs = np >> 2;
    // this block's rows of M2 and of A
    const int n0 = min(n, rank * rows_n);
    const int nc = min(n, n0 + rows_n) - n0;
    const int m0 = min(m, rank * rows_m);
    const int mc = min(m, m0 + rows_m) - m0;

    // the vectors, all zeroed first (pads must read as zero)
    const int vec_floats = m2_vec_floats(n, rows_n, rows_m, C, T);
    for (int k = t; k < vec_floats; k += T) smem[k] = 0.f;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    float* p = smem + BARRIER_FLOATS;
    float* x = p;     p += np;
    float* q = p;     p += np;
    float* xt = p;    p += np;
    float* rhs = p;   p += rows_n + REG_ROWS;   // on this block's rows of M2
    float* z = p;     p += rows_m;      // this block's rows of the m-vectors
    float* y = p;     p += rows_m;
    float* w = p;     p += rows_m;
    float* lo = p;    p += rows_m;
    float* hi = p;    p += rows_m;
    float* rho = p;   p += rows_m;
    float* rinv = p;  p += rows_m;
    float* part = p;  p += m2_part_floats(n, rows_m, T);
    float* ex1 = p;   p += C * rows_n;  // slot c: block c's A_c' w_c, my rows
    float* ex2 = p;   p += C * np;      // slot c: block c's M2_c' rhs_c
    __syncthreads();
    if (t == 0) {
        for (int k = 0; k < N_STEPS; ++k) barrier_init(bars + k);
        // visible to the other blocks' stores after the cluster barrier
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }

    // this block's slices: in shared memory (stride ld), in registers, or
    // read from device memory every iteration (stride n)
    const float* M2_p = a.M2 + (size_t)b * n * n + (size_t)n0 * n;
    const float* A_p = a.A + (size_t)b * m * n + (size_t)m0 * n;
    int ld_m2 = n, ld_a = n;
    if (resident & RES_M2) {
        load_rows(p, ld, M2_p, nc, n, t, T);
        M2_p = p;
        ld_m2 = ld;
        p += rows_n * ld;
    }
    if (resident & RES_A) {
        load_rows(p, ld, A_p, mc, n, t, T);
        A_p = p;
        ld_a = ld;
    }
    float4 mr[REGS ? REG_ROWS : 1];
    if constexpr (REGS) {
        const int ch = t / cgs, j = 4 * (t - ch * cgs);
#pragma unroll
        for (int r = 0; r < REG_ROWS; ++r) {
            const int i = ch * REG_ROWS + r;
            const float* row = M2_p + (size_t)i * n;
            const bool ok = t < cgs * cdiv(rows_n, REG_ROWS) && i < nc;
            mr[r].x = ok && j < n ? row[j] : 0.f;
            mr[r].y = ok && j + 1 < n ? row[j + 1] : 0.f;
            mr[r].z = ok && j + 2 < n ? row[j + 2] : 0.f;
            mr[r].w = ok && j + 3 < n ? row[j + 3] : 0.f;
        }
    }

    for (int j = t; j < n; j += T) {
        x[j] = a.x0[(size_t)b * n + j];
        q[j] = a.q[(size_t)b * n + j];
    }
    for (int i = t; i < mc; i += T) {
        const size_t gi = (size_t)b * m + m0 + i;
        const float rh = a.rho[gi];
        const float zi = a.z0[gi];
        const float yi = a.y0[gi];
        z[i] = zi;
        y[i] = yi;
        lo[i] = a.l[gi];
        hi[i] = a.u[gi];
        rho[i] = rh;
        rinv[i] = 1.0f / rh;
        w[i] = rh * zi - yi;
    }
    // every block of the cluster is running and loaded: from here on they
    // store into each other
    cp_async_wait();
    cluster.sync();

    // geometry of the products
    const int chT = max(1, T / cgs);
    const int L_a = round4(cdiv(mc, chT));
    const int ch_a = L_a > 0 ? cdiv(mc, L_a) : 0;           // A_r' w_r
    const int L_m = REGS ? REG_ROWS : round4(cdiv(nc, chT));
    const int ch_m = L_m > 0 ? cdiv(nc, L_m) : 0;           // M2_r' rhs_r
    const bool a_smem = (resident & RES_A) != 0;
    const int kch = a_smem ? max(1, T / max(mc, 1)) : 1;
    const int KL = round4(cdiv(np, kch));
    const int kch_used = a_smem ? cdiv(np, KL) : 1;         // A_r x_t
    const bool wide_a = (ld_a & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(A_p) & 15) == 0;
    const bool wide_m2 = (ld_m2 & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(M2_p) & 15) == 0;

    // bytes each step brings into this block from all blocks together
    const unsigned bytes1 = 4u * C * (unsigned)round4(nc);
    const unsigned bytes2 = 4u * C * (unsigned)np;
    const float sigma = a.sigma, alpha = a.alpha;
    const float one_m_alpha = 1.0f - alpha;
    for (int it = 0; it < a.iters; ++it) {
        const unsigned phase = it & 1;
        // 1. partial A_r' w_r; its piece on block o's rows goes to block o
        if (wide_a)
            matT_vec_chunks<true>(A_p, ld_a, mc, n, w, part, np, ch_a, L_a);
        else
            matT_vec_chunks<false>(A_p, ld_a, mc, n, w, part, np, ch_a, L_a);
        __syncthreads();
        if (t == 0) barrier_expect(bars + 0, bytes1);
        for (int g = t; g < cgs; g += T) {
            const int j = 4 * g;
            const int owner = j / rows_n;
            store4_to(owner, ex1, rank * rows_n + (j - owner * rows_n),
                      sum_chunks4(part, np, ch_a, j), bars + 0);
        }
        barrier_wait(bars + 0, phase);
        // rhs = sigma x - q + sum over the blocks, in rank order
        for (int i = t; i < nc; i += T) {
            float s = ex1[i];
            for (int c = 1; c < C; ++c) s += ex1[c * rows_n + i];
            rhs[i] = (sigma * x[n0 + i] - q[n0 + i]) + s;
        }
        __syncthreads();

        // 2. partial M2_r' rhs_r, to every block
        if constexpr (REGS)
            matT_vec_regs(mr, rhs, part, np, ch_m);
        else if (wide_m2)
            matT_vec_chunks<true>(M2_p, ld_m2, nc, n, rhs, part, np, ch_m,
                                  L_m);
        else
            matT_vec_chunks<false>(M2_p, ld_m2, nc, n, rhs, part, np, ch_m,
                                   L_m);
        __syncthreads();
        if (t == 0) barrier_expect(bars + 1, bytes2);
        for (int g = t; g < cgs; g += T)
            store4_all(C, ex2, rank * np + 4 * g,
                       sum_chunks4(part, np, ch_m, 4 * g), bars + 1);
        barrier_wait(bars + 1, phase);
        // x_t = sum over the blocks in rank order (every block alike)
        for (int j = t; j < n; j += T) {
            float s = ex2[j];
            for (int c = 1; c < C; ++c) s += ex2[c * np + j];
            xt[j] = s;
            x[j] = alpha * s + one_m_alpha * x[j];
        }
        __syncthreads();

        // 3. z_t = A_r x_t and the z / y / w updates of this block's rows
        if (a_smem)
            mat_vec_chunks(A_p, ld_a, mc, np, xt, part, kch_used, KL);
        else
            mat_vec_streamed(A_p, ld_a, mc, n, xt, part);
        __syncthreads();
        for (int i = t; i < mc; i += T) {
            float acc = part[i];
            for (int c = 1; c < kch_used; ++c) acc += part[c * mc + i];
            const float zr = alpha * acc + one_m_alpha * z[i];
            const float yi = y[i];
            const float rh = rho[i];
            const float zn = fminf(fmaxf(zr + rinv[i] * yi, lo[i]), hi[i]);
            const float yn = yi + rh * (zr - zn);
            z[i] = zn;
            y[i] = yn;
            w[i] = rh * zn - yn;
        }
        __syncthreads();
    }

    if (rank == 0)
        for (int j = t; j < n; j += T) a.x_out[(size_t)b * n + j] = x[j];
    for (int i = t; i < mc; i += T) {
        a.z_out[(size_t)b * m + m0 + i] = z[i];
        a.y_out[(size_t)b * m + m0 + i] = y[i];
    }
    // no block leaves while a neighbour may still store into it
    cluster.sync();
}

}  // namespace

// The kernel of a layout and its launch configuration (attributes[0] must
// outlive the configuration), its dynamic shared memory opted in.
static cudaError_t cluster_launch_config(int B, int cluster, int threads,
                                         int resident, int smem_floats,
                                         void* stream,
                                         cudaLaunchAttribute* attributes,
                                         cudaLaunchConfig_t* config,
                                         void (**kernel)(M2Args, int, int,
                                                         int, int))
{
    *kernel = (resident & RES_M2_REGS) ? admm_m2_cluster_kernel<true>
                                       : admm_m2_cluster_kernel<false>;
    const size_t smem = sizeof(float) * (size_t)smem_floats;
    const cudaError_t err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *config = {};
    config->gridDim = dim3((unsigned)B * (unsigned)cluster, 1, 1);
    config->blockDim = dim3((unsigned)threads, 1, 1);
    config->dynamicSmemBytes = smem;
    config->stream = (cudaStream_t)stream;
    attributes[0].id = cudaLaunchAttributeClusterDimension;
    attributes[0].val.clusterDim.x = (unsigned)cluster;
    attributes[0].val.clusterDim.y = 1;
    attributes[0].val.clusterDim.z = 1;
    config->attrs = attributes;
    config->numAttrs = 1;
    return cudaSuccess;
}

extern "C" {

// How many clusters of this geometry the card holds at once (the
// occupancy calculator's answer), or minus the CUDA error code.
int admm_m2_active_clusters(int cluster, int threads, int resident,
                            int smem_floats)
{
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config;
    void (*kernel)(M2Args, int, int, int, int);
    cudaError_t err = cluster_launch_config(1, cluster, threads, resident,
                                            smem_floats, nullptr, attr,
                                            &config, &kernel);
    if (err != cudaSuccess) return -(int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &config);
    if (err != cudaSuccess) return -(int)err;
    return clusters;
}

// Launch on `stream` with the geometry of the wrapper's m2_layout(): a
// cluster of `cluster` blocks of `threads` threads per scenario, row stride
// `ld` in shared memory, `resident` saying where the slices live (RES_M2 |
// RES_A | RES_M2_REGS), `smem_floats` the floats of shared memory per block
// as the wrapper reckoned them (checked here).  A cluster that the occupancy
// calculator cannot place returns ERR_UNSCHEDULABLE (see
// admm_m2_error_string); nothing is handed to another layout.  Returns the
// CUDA error code of the launch (0 = success).
int admm_m2_launch(const float* M2, const float* A, const float* q,
                   const float* l, const float* u, const float* rho,
                   const float* x0, const float* z0, const float* y0,
                   float* x_out, float* z_out, float* y_out,
                   int B, int n, int m, int iters, float sigma, float alpha,
                   int cluster, int threads, int ld, int resident,
                   int smem_floats, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || cluster < 1 ||
        cluster > MAX_CLUSTER || threads < 32 || threads > MAX_THREADS ||
        (threads & 31) != 0 || (ld & 3) != 0 || ld < round4(n) ||
        resident < 0 || resident > 7 ||
        ((resident & RES_M2) && (resident & RES_M2_REGS)))
        return (int)cudaErrorInvalidValue;
    const int rows_n = round4(cdiv(n, cluster));
    const int rows_m = round4(cdiv(m, cluster));
    if ((resident & RES_M2_REGS) &&
        (round4(n) / 4) * cdiv(rows_n, REG_ROWS) > threads)
        return (int)cudaErrorInvalidValue;
    int want = m2_vec_floats(n, rows_n, rows_m, cluster, threads);
    if (resident & RES_M2) want += rows_n * ld;
    if (resident & RES_A) want += rows_m * ld;
    if (smem_floats != want) return (int)cudaErrorInvalidValue;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (sizeof(float) * (size_t)smem_floats > (size_t)max_smem)
        return (int)cudaErrorInvalidValue;

    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config;
    void (*kernel)(M2Args, int, int, int, int);
    err = cluster_launch_config(B, cluster, threads, resident, smem_floats,
                                stream, attr, &config, &kernel);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &config);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return ERR_UNSCHEDULABLE;
    const M2Args args = {M2, A, q, l, u, rho, x0, z0, y0, x_out, z_out, y_out,
                         B, n, m, iters, sigma, alpha};
    err = cudaLaunchKernelEx(&config, kernel, args, ld, rows_n, rows_m,
                             resident);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* admm_m2_error_string(int code)
{
    if (code == ERR_UNSCHEDULABLE)
        return "the cluster cannot be scheduled: "
               "cudaOccupancyMaxActiveClusters reports 0 clusters of this "
               "size, block size and shared memory";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
