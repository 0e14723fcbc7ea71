// The generic ADMM iteration with every mat-vec on the tensor cores — CUDA,
// sm_90a.
//
// Replaces the TPU kernel `_admm_kernel` (reached through `admm_iterate`,
// backend "pallas") of mpctsid_tpu/qp/pallas_kernels.py: the form of the
// generic iteration whose five products are HIGHEST-precision `dot_general`s
// on the matrix unit.  Per scenario, `iters` times:
//
//     rhs = sigma x - q + A' w             (w = rho z - y; A transposed)
//     x_a = K^-1 rhs                       (K^-1 as given)
//     r   = rhs - K x_a                    (K AS GIVEN: unlike admm_vpu.cu)
//     x_t = x_a + K^-1 r                   (K^-1 as given)
//     z_t = A x_t                          (A as given)
//     x   = alpha x_t + (1 - alpha) x
//     z_r = alpha z_t + (1 - alpha) z
//     z   = clip(z_r + y / rho, l, u);   y = y + rho (z_r - z)
//
// K and K^-1 are symmetric only up to rounding, so the sides are part of the
// function.  Valid with equality rows (the residual is formed explicitly).
// Any n, m, B >= 1; no tensor is padded in device memory.
//
// Tensor-core mat-vec.  Every scenario has its own K^-1, K and A, so there
// is nothing to batch into the N dimension of a matrix product: each product
// is a true mat-vec, done with warp-level
//     mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// A 16 x 8 tile of the matrix is the A operand, the vector sits in the
// columns of the 8 x 8 B operand, and a warp owns 16 output rows.  Fragment
// layout used (lane = 4 g + t, g = 0..7, t = 0..3):
//     A (16 x 8):  a0 = (row g, k t)       a1 = (row g + 8, k t)
//                  a2 = (row g, k t + 4)   a3 = (row g + 8, k t + 4)
//     B (8 x 8):   b0 = (k t, col g)       b1 = (k t + 4, col g)
//     D (16 x 8):  d0, d1 = (row g, cols 2 t, 2 t + 1)
//                  d2, d3 = (row g + 8, cols 2 t, 2 t + 1)
// The sum over k does not care which depth index sits in which k slot, as
// long as A and B agree, so a 16-deep chunk is dealt as: lane t holds the
// four consecutive depth indices k0 + 4 t + c; c = 0, 1 feed slots t, t + 4
// of a first mma, c = 2, 3 those of a second.  Nor does it matter which 16
// outputs are called rows 0..15.  "As given" the lane's rows g and g + 8 are
// those outputs, and it reads 16 consecutive floats of a matrix row per group
// of four lanes: one 16-byte load per lane and row.  "Transposed" its rows
// are the outputs 2 g and 2 g + 1, neighbours in a matrix row: one 8-byte
// load per lane and depth index.  The vector's four elements are one 16-byte
// load on both sides.  Nothing in the loop carries a predicate: a tile or a
// chunk that reaches past the matrix reads the last valid row, column or
// piece instead (the vectors are zero-padded in shared memory, so what a
// clamped read meets is multiplied by zero, and outputs past the end are not
// written), and only the last chunk of a ragged depth clamps at all.
//
// Precision.  Plain TF32 keeps 11 significant bits and would break the f32
// contract, so every operand is split in the kernel: p0 = rna_tf32(v),
// p1 = rna_tf32(v - p0) (two parts, "3xTF32"; the difference is exact), or
// three parts, which represent an f32 exactly.  The parts of the vector sit
// in columns 0, 1 (, 2) of B, so one mma per part of the matrix gives every
// cross term; with two parts that is two mma per tile.  The tensor core
// rounds its accumulator toward zero, so no running sum is kept in it: every
// mma starts from C = 0 (its eight-product partial sums are rounded once)
// and the partial sums are added in f32 registers, smallest part first.
// A' w, K^-1 rhs, K^-1 r and A x_t take two parts (PARTS), the cancelling
// product K x_a of the residual three (RESID_PARTS): the comment at
// `admm_iterate` in qp/kernels.py has the measured errors behind the choice.
//
// What bounds it on this card, and the design.  The card's bound is bytes:
// K^-1, K, A and the vectors once per scenario (chip_smoke.py computes it
// from the run's shapes; the operations side, iters * (4 m n + 6 n^2) against
// a third of the TF32 rate, is the smaller at both shapes of the main path).
// What bounds THIS kernel is the instruction stream of the products: a
// 16 x 16 piece of a matrix costs a warp some 70 instructions (two 16-byte
// loads, eight splits, four mma, sixteen adds) for 256 useful multiply-adds,
// one column of the tensor cores' eight, and a warp takes some 500 cycles
// over them with three warps per scheduler.  The matrices' traffic, which the
// design below removes, was hidden behind that (measured:
// scripts/probe_kernel_designs.py, PERF.md).  Two paths, chosen by the
// wrapper's `mma_layout` from (B, n, m), the block's shared-memory limit and
// the number of multiprocessors:
//
//   * CLUSTER path (admm_mma_cluster_kernel).  One block per scenario cannot
//     hold the matrices at the MPC shape (n = 192, m = 320: 540,672 B
//     against a block's 232,448 B).  A thread-block cluster of C blocks on
//     neighbouring multiprocessors works on one scenario, C the least of 1
//     to 8 at which everything fits (3 at the MPC shape).
//     Block r owns rows [r rows_n, (r + 1) rows_n) of K^-1 and of K and rows
//     [r rows_m, (r + 1) rows_m) of A (slices of whole 16-row tiles, the
//     last one ragged), loads them from device memory ONCE and keeps them in
//     its shared memory.  The m-vectors (z, y, w, l, u, rho, 1 / rho) live
//     only with the block that owns those rows; the n-vectors (x, rhs, x_a,
//     r, x_t, the last four also as the TF32 parts the products read) are
//     held whole by every block.  Per iteration each block forms
//     its PARTIAL A_r' w_r and stores it into slot r of a C x n buffer in
//     every block of the cluster (distributed shared memory); every block
//     sums the C slots in rank order, so all hold the same rhs bit for bit
//     and no atomics are needed.  Its rows of x_a, r and x_t are likewise
//     stored into every block.  z_t = A_r x_t and the projection are local.
//     The exchange: four steps per iteration.  A whole-cluster barrier
//     (cluster.sync()) after each step compiles to a device-wide memory fence
//     and cost 8 of 40 ms at the MPC shape.  Instead every value is an
//     asynchronous store (st.async) into the other block's shared memory
//     that reports its bytes to a transaction barrier (mbarrier) there; the
//     receiver posts the bytes a step brings and waits for them.  No fence,
//     no rendezvous: a block waits only for data it is about to read.  That
//     is safe without a second barrier because each step's stores are issued
//     only after the sender has received the step before, which every block
//     sends after it has finished reading what the new stores overwrite.
//     Inside a block a product is cut into (16-row tile, depth slice) units
//     so that the warps are evenly loaded; partial sums meet in shared
//     memory (seven block barriers per iteration).  The slices arrive by
//     cp.async, so that a block has all its loads in flight at once.  Where
//     even C = 8 does not hold all three slices, the rest (in the order K,
//     A, K^-1) is read from device memory / L2 every iteration.
//     The fewer blocks share a scenario the better: an exchange costs the
//     same whatever work lies between two of them, and with one block per
//     multiprocessor nothing overlaps it.
//   * WARP path (admm_mma_warp_kernel).  At the WBC shape (n = 30, m = 50)
//     a block per scenario spends its time in block barriers.  Where one
//     scenario's K^-1, K, A and vectors fit a fraction of a block's shared
//     memory, a block holds g scenarios, ONE WARP each: the warp walks all
//     tiles of a product with the whole depth, writes the result vector
//     itself and orders its own shared-memory traffic with __syncwarp().  No
//     partial sums, no block barrier after the load, nothing crosses
//     scenarios.  Blocks are small (at most four warps) and several share a
//     multiprocessor, so that one loads while another computes.
//
// Row stride.  In shared memory rows are padded to a multiple of four
// floats, for the 16-byte and 8-byte loads.  A stride of 16 (mod 32) floats
// would also keep the rows of a quarter warp on different banks; measured at
// both shapes it bought nothing (MPC shape: 192, 196 and 208 within 2 %) and
// at n = 30 it cost 25 %, because 48 instead of 32 floats per row leave room
// for 9 instead of 12 scenarios per multiprocessor.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, B = 4096): WBC
// shape (n = 30, m = 50, 13 iterations) 0.355 ms, MPC shape (n = 192,
// m = 320, 30 iterations) 30.9 ms; one block per scenario with the matrices
// streamed, the design before, 0.595 and 41.7 ms; the generic FMA kernel
// (admm_vpu.cu) 0.650 and 36.8 ms.  PERF.md keeps the table and where the
// cycles go.
//
// Plain C interface (loaded with ctypes): device pointers and the stream as
// integers, launch on that stream, no allocation, no synchronisation; returns
// the CUDA error code of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "admm_block.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace admm_block;

constexpr int MAX_KSPLIT = 8;   // depth slices per product, at most
constexpr int PARTS = 2;        // TF32 parts per operand: A' w, K^-1 ., A x_t
constexpr int RESID_PARTS = 3;  // and of K x_a (an exact split of an f32)
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_WARP_SLOTS = 4;   // scenarios (warps) per block, warp path
constexpr int RES_KINV = 1, RES_A = 2, RES_K = 4;   // `resident` bits
// cluster path: the steps of an iteration that end in an exchange between
// the blocks (A' w, x_a, r, x_t), each with an 8-byte barrier of its own
constexpr int N_STEPS = 4;
constexpr int BARRIER_FLOATS = 2 * N_STEPS;

__host__ __device__ __forceinline__ int pad16(int v) { return (v + 15) & ~15; }

// x rounded to TF32 (11 significant bits), ties away from zero: what
// cvt.rna.tf32.f32 gives, bit for bit, on finite values, in two integer
// instructions (the kernel measured 12 % slower with the conversion
// instruction at both shapes of the main path).
__device__ __forceinline__ uint32_t to_tf32(float x)
{
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = p[0] + p[1] (+ p[2]) up to 2^-23 |x| (two parts) or exactly (three);
// each remainder x - p[s] is exact in f32.  The third part is what two
// roundings to 11 bits leave of 24: at most two bits, a TF32 number as it is.
template <int NS>
__device__ __forceinline__ void split_tf32(float x, uint32_t (&p)[NS])
{
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        p[s] = s < 2 ? to_tf32(x) : __float_as_uint(x);
        x -= __uint_as_float(p[s]);
    }
}

// A vector as the B operand reads it: part s of element k at
// parts[s * stride + k], each part array zero-padded to a multiple of 16.
// The split is done once, where the element is written, not once per tile.
struct SplitVec {
    float* parts;
    int stride;
};

template <int NS>
__device__ __forceinline__ void store_split(const SplitVec& v, int k, float x)
{
    uint32_t p[NS];
    split_tf32<NS>(x, p);
#pragma unroll
    for (int s = 0; s < NS; ++s)
        v.parts[s * v.stride + k] = __uint_as_float(p[s]);
}

// D = A B with C = 0.
__device__ __forceinline__ void mma_m16n8k8_tf32(
    float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1)
{
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
}

// One 16 x 8 step: rows g, g + 8 of the tile against depth slots t, t + 4.
// e<row><slot> are this lane's matrix elements; b0 / b1 its elements of the
// B operand for the two slots: column g of B holds part g of the vector.
// acc0 / acc1 gain this lane's two columns of rows g / g + 8: in the lanes
// t = 0 the products with parts 0 and 1, in the lanes t = 1 those with
// parts 2 and 3.
template <int NS>
__device__ __forceinline__ void tile_step(
    float& acc0, float& acc1, float e00, float e10, float e01, float e11,
    float b0, float b1)
{
    uint32_t a0[NS], a1[NS], a2[NS], a3[NS];
    split_tf32<NS>(e00, a0);
    split_tf32<NS>(e10, a1);
    split_tf32<NS>(e01, a2);
    split_tf32<NS>(e11, a3);
    const uint32_t u0 = __float_as_uint(b0), u1 = __float_as_uint(b1);
    float d[4];
    mma_m16n8k8_tf32(d, a0[NS - 1], a1[NS - 1], a2[NS - 1], a3[NS - 1], u0,
                     u1);                     // smallest part first
    float s0 = d[0] + d[1], s1 = d[2] + d[3];
#pragma unroll
    for (int s = NS - 2; s >= 0; --s) {
        mma_m16n8k8_tf32(d, a0[s], a1[s], a2[s], a3[s], u0, u1);
        s0 += d[0] + d[1];
        s1 += d[2] + d[3];
    }
    acc0 += s0;
    acc1 += s1;
}

// How many depth slices make `n_warps` warps evenly loaded: least
// (rounds of units) x (chunks per unit).
__device__ __forceinline__ int pick_ksplit(int out_len, int depth, int n_warps)
{
    const int tiles = (out_len + 15) >> 4;
    const int chunks = (depth + 15) >> 4;
    int best = 1, best_cost = 0x7fffffff;
    for (int s = 1; s <= MAX_KSPLIT && s <= chunks; ++s) {
        const int cost = ((tiles * s + n_warps - 1) / n_warps)
                         * ((chunks + s - 1) / s);
        if (cost < best_cost) { best_cost = cost; best = s; }
    }
    return best;
}

// One 16-deep chunk of a tile: this lane's depth indices are kk + c, c = 0..3
// (kk = 16 ch + 4 t).  vq points at part g of the vector.
//   as given:    m0 / m1 point at the lane's two matrix rows;
//   transposed:  m0 / m1 point at its two matrix columns in row 0 (WIDE: the
//                columns are neighbours and m0 is read in 8-byte pieces).
// WIDE: 16-byte (as given) or 8-byte (transposed) loads.  CLAMP: the chunk
// may reach past `depth`; the vector is zero there, so the matrix is read at
// the last valid place instead and no load needs a predicate.
template <int NS, bool TRANS, bool WIDE, bool CLAMP>
__device__ __forceinline__ void chunk_step(
    float& acc0, float& acc1, const float* m0, const float* m1, int ld,
    const float* vq, bool zero_col, int kk, int depth)
{
    const float4 v4 = *reinterpret_cast<const float4*>(vq + kk);
    float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    if (NS & 1) {     // column NS of B is summed with column NS - 1: zero it
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c] = zero_col ? 0.f : vv[c];
    }
    float e0[4], e1[4];
    if (!TRANS && WIDE) {
        const int kc = CLAMP ? min(kk, ((depth + 3) & ~3) - 4) : kk;
        const float4 r0 = *reinterpret_cast<const float4*>(m0 + kc);
        const float4 r1 = *reinterpret_cast<const float4*>(m1 + kc);
        e0[0] = r0.x; e0[1] = r0.y; e0[2] = r0.z; e0[3] = r0.w;
        e1[0] = r1.x; e1[1] = r1.y; e1[2] = r1.z; e1[3] = r1.w;
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int kc = CLAMP ? min(kk + c, depth - 1) : kk + c;
            if (!TRANS) {
                e0[c] = m0[kc];
                e1[c] = m1[kc];
            } else if (WIDE) {
                const float2 pr =
                    *reinterpret_cast<const float2*>(m0 + kc * ld);
                e0[c] = pr.x;
                e1[c] = pr.y;
            } else {
                e0[c] = m0[kc * ld];
                e1[c] = m1[kc * ld];
            }
        }
    }
    tile_step<NS>(acc0, acc1, e0[0], e1[0], e0[1], e1[1], vv[0], vv[1]);
    tile_step<NS>(acc0, acc1, e0[2], e1[2], e0[3], e1[3], vv[2], vv[3]);
}

// A mat-vec on the tensor cores by warps `warp`, `warp + n_warps`, ...:
//   TRANS = false:  out[i] = sum_k mat[i * ld + k] vec[k]   (mat as given)
//   TRANS = true:   out[j] = sum_i mat[i * ld + j] vec[i]   (mat transposed)
// out has `out_len` entries, the sum runs over `depth`, cut into `ksplit`
// slices.  `vec` holds the NS parts of the vector in shared memory, each
// 16-byte aligned and zero-padded to a multiple of 16.  For slice ks and
// output o one lane calls emit(ks, o, sum).
// mat may lie in shared or global memory and must be finite (a clamped read
// is multiplied by zero); ld * (rows of mat) < 2^31.  Where its rows are
// aligned and padded (with zeros) to a multiple of four floats the loads are
// wide (WIDE).
// The lane's outputs of a tile are rows g and g + 8 (as given) or columns
// 2 g and 2 g + 1 (transposed).  Outputs past out_len are computed from the
// last valid row or column and not emitted.
template <int NS, bool TRANS, bool WIDE, class Emit>
__device__ __forceinline__ void mma_matvec_units(
    const float* mat, int ld, int out_len, int depth, const SplitVec& vec,
    int ksplit, int warp, int n_warps, Emit emit)
{
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // column g of the B operand: part g of the vector.  Only the columns
    // below NS (rounded up to even) are summed; the others repeat a part.
    const float* vq = vec.parts + min(g, NS - 1) * vec.stride;
    const bool zero_col = g == NS;
    const int n_tiles = (out_len + 15) >> 4;
    const int n_chunks = (depth + 15) >> 4;
    const int per_slice = (n_chunks + ksplit - 1) / ksplit;
    const int n_full = depth >> 4;      // chunks wholly inside `depth`

    for (int unit = warp; unit < n_tiles * ksplit; unit += n_warps) {
        const int ks = ksplit == 1 ? 0 : unit / n_tiles;
        const int tile = unit - ks * n_tiles;
        const int o0 = tile * 16 + (TRANS ? 2 * g : g);
        const int o1 = o0 + (TRANS ? 1 : 8);
        const float *m0, *m1;
        if (!TRANS) {
            m0 = mat + min(o0, out_len - 1) * ld;
            m1 = mat + min(o1, out_len - 1) * ld;
        } else if (WIDE) {
            m0 = m1 = mat + min(o0, ((out_len + 1) & ~1) - 2);
        } else {
            m0 = mat + min(o0, out_len - 1);
            m1 = mat + min(o1, out_len - 1);
        }
        int ch = ks * per_slice;
        const int ch_end = min(n_chunks, ch + per_slice);
        const int ch_full = min(ch_end, n_full);
        int kk = ch * 16 + 4 * t;
        float acc0 = 0.f, acc1 = 0.f;
        // (unrolling bought nothing: measured 1, 2 and 4 at both shapes)
#pragma unroll 1
        for (; ch < ch_full; ++ch, kk += 16)
            chunk_step<NS, TRANS, WIDE, false>(acc0, acc1, m0, m1, ld, vq,
                                               zero_col, kk, depth);
        if (ch < ch_end)    // the last chunk of a ragged depth
            chunk_step<NS, TRANS, WIDE, true>(acc0, acc1, m0, m1, ld, vq,
                                              zero_col, kk, depth);
        if (NS > 2) {       // parts 2 (and 3) lie in the lanes t = 1
            acc0 += __shfl_down_sync(0xffffffffu, acc0, 1);
            acc1 += __shfl_down_sync(0xffffffffu, acc1, 1);
        }
        if (t == 0) {
            if (o0 < out_len) emit(ks, o0, acc0);
            if (o1 < out_len) emit(ks, o1, acc1);
        }
    }
}

template <int NS, bool TRANS, class Emit>
__device__ __forceinline__ void mma_matvec(
    const float* mat, int ld, int out_len, int depth, const SplitVec& vec,
    int ksplit, int warp, int n_warps, Emit emit)
{
    const uintptr_t addr = reinterpret_cast<uintptr_t>(mat);
    const bool wide = TRANS
        ? (ld & 1) == 0 && (addr & 7) == 0 && ((out_len + 1) & ~1) <= ld
        : (ld & 3) == 0 && (addr & 15) == 0 && ((depth + 3) & ~3) <= ld;
    if (wide)
        mma_matvec_units<NS, TRANS, true>(mat, ld, out_len, depth, vec,
                                          ksplit, warp, n_warps, emit);
    else
        mma_matvec_units<NS, TRANS, false>(mat, ld, out_len, depth, vec,
                                           ksplit, warp, n_warps, emit);
}

// Asynchronous copies device memory -> shared memory (no register in
// between, any number in flight); the issuing thread waits with
// cp_async_wait(), then a barrier makes them visible to the others.
__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `rows` rows of a row-major (., n) matrix in device memory -> shared memory
// with the row stride ld (a multiple of four), asynchronously; the pad
// columns are zeroed.  Call cp_async_wait() before the barrier that
// publishes the rows.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int rows, int n, int t, int T)
{
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int ld4 = ld >> 2;
        for (int k = t; k < rows * ld4; k += T) {
            const int i = k / ld4, j = (k - i * ld4) << 2;
            if (j < n)
                cp_async16(dst + 4 * k, src + (size_t)i * n + j);
            else
                reinterpret_cast<float4*>(dst)[k] =
                    make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
        for (int k = t; k < rows * ld; k += T) {
            const int i = k / ld, j = k - i * ld;
            if (j < n)
                cp_async4(dst + k, src + (size_t)i * n + j);
            else
                dst[k] = 0.f;
        }
    }
}

// What every path is given: the problem of B scenarios and where to write.
struct IterArgs {
    const float *Kinv, *K, *A, *q, *l, *u, *rho, *x0, *z0, *y0;
    float *x_out, *z_out, *y_out;
    int B, n, m, iters;
    float sigma, alpha;
};

// Floats of shared memory: one scenario's slot on the warp path, one block
// on the cluster path (the wrapper's mma_layout() computes the same).
__host__ __device__ __forceinline__ int warp_slot_floats(int n, int m, int ld)
{
    return (2 * n + m) * ld + 13 * pad16(n) + 9 * pad16(m);
}

__host__ __device__ __forceinline__ int cluster_vec_floats(int n, int rows_m,
                                                           int cluster)
{
    const int np = pad16(n);
    return 14 * np + 9 * rows_m + MAX_KSPLIT * (np > rows_m ? np : rows_m)
           + cluster * np + BARRIER_FLOATS;
}

// ---- the warp path ----------------------------------------------------------

__global__ void __launch_bounds__(32 * MAX_WARP_SLOTS)
admm_mma_warp_kernel(IterArgs a, int ld)
{
    extern __shared__ __align__(16) float smem[];
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int G = T >> 5;
    const int b0 = blockIdx.x * G;
    const int n = a.n, m = a.m;
    const int np = pad16(n), mp = pad16(m);
    const int mat_floats = (2 * n + m) * ld;
    const int slot_floats = warp_slot_floats(n, m, ld);

    // the whole block copies the matrices of its scenarios, rows padded to
    // ld, and zeroes their vectors (the pads must read as zero)
    for (int s = 0; s < G && b0 + s < a.B; ++s) {
        float* sKinv = smem + (size_t)s * slot_floats;
        float* sK = sKinv + n * ld;
        float* sA = sK + n * ld;
        load_rows(sKinv, ld, a.Kinv + (size_t)(b0 + s) * n * n, n, n, t, T);
        load_rows(sK, ld, a.K + (size_t)(b0 + s) * n * n, n, n, t, T);
        load_rows(sA, ld, a.A + (size_t)(b0 + s) * m * n, m, n, t, T);
        for (int k = t; k < slot_floats - mat_floats; k += T)
            sA[m * ld + k] = 0.f;
    }
    cp_async_wait();
    __syncthreads();

    const int b = b0 + warp;
    if (b >= a.B) return;

    const float* sKinv = smem + (size_t)warp * slot_floats;
    const float* sK = sKinv + n * ld;
    const float* sA = sK + n * ld;
    float* p = smem + (size_t)warp * slot_floats + mat_floats;
    float* x = p;    p += np;
    float* q = p;    p += np;
    float* rhs = p;  p += np;
    float* xa = p;   p += np;
    // what the products read: the TF32 parts of rhs, x_a, r, x_t and w
    const SplitVec rhs_s = {p, np};  p += PARTS * np;
    const SplitVec xa_s = {p, np};   p += RESID_PARTS * np;
    const SplitVec r_s = {p, np};    p += PARTS * np;
    const SplitVec xt_s = {p, np};   p += PARTS * np;
    IterVecs v;      // the m-vectors, as project_row takes them
    v.z = p;    p += mp;
    v.y = p;    p += mp;
    v.w = p;    p += mp;
    v.l = p;    p += mp;
    v.u = p;    p += mp;
    v.rho = p;  p += mp;
    v.rinv = p; p += mp;
    const SplitVec w_s = {p, mp};

    for (int j = lane; j < n; j += 32) {
        x[j] = a.x0[(size_t)b * n + j];
        q[j] = a.q[(size_t)b * n + j];
    }
    for (int i = lane; i < m; i += 32) {
        const float rh = a.rho[(size_t)b * m + i];
        const float zi = a.z0[(size_t)b * m + i];
        const float yi = a.y0[(size_t)b * m + i];
        v.z[i] = zi;
        v.y[i] = yi;
        v.l[i] = a.l[(size_t)b * m + i];
        v.u[i] = a.u[(size_t)b * m + i];
        v.rho[i] = rh;
        v.rinv[i] = 1.0f / rh;
        v.w[i] = rh * zi - yi;
        store_split<PARTS>(w_s, i, v.w[i]);
    }
    __syncwarp();

    const float sigma = a.sigma, alpha = a.alpha;
    const float one_m_alpha = 1.0f - alpha;
    for (int it = 0; it < a.iters; ++it) {
        mma_matvec<PARTS, true>(sA, ld, n, m, w_s, 1, 0, 1,
            [&](int, int j, float acc) {
                rhs[j] = (sigma * x[j] - q[j]) + acc;
                store_split<PARTS>(rhs_s, j, rhs[j]);
            });
        __syncwarp();
        mma_matvec<PARTS, false>(sKinv, ld, n, n, rhs_s, 1, 0, 1,
            [&](int, int i, float acc) {
                xa[i] = acc;
                store_split<RESID_PARTS>(xa_s, i, acc);
            });
        __syncwarp();
        mma_matvec<RESID_PARTS, false>(sK, ld, n, n, xa_s, 1, 0, 1,
            [&](int, int i, float acc) {                       // K as given
                store_split<PARTS>(r_s, i, rhs[i] - acc);
            });
        __syncwarp();
        mma_matvec<PARTS, false>(sKinv, ld, n, n, r_s, 1, 0, 1,
            [&](int, int i, float acc) {
                const float xti = xa[i] + acc;
                store_split<PARTS>(xt_s, i, xti);
                x[i] = alpha * xti + one_m_alpha * x[i];
            });
        __syncwarp();
        mma_matvec<PARTS, false>(sA, ld, m, n, xt_s, 1, 0, 1,
            [&](int, int i, float acc) {
                project_row(v, i, acc, alpha, one_m_alpha);
                store_split<PARTS>(w_s, i, v.w[i]);
            });
        __syncwarp();
    }

    for (int j = lane; j < n; j += 32) a.x_out[(size_t)b * n + j] = x[j];
    for (int i = lane; i < m; i += 32) {
        a.z_out[(size_t)b * m + i] = v.z[i];
        a.y_out[(size_t)b * m + i] = v.y[i];
    }
}

// ---- the cluster path -------------------------------------------------------

// The exchange between the blocks of a cluster.  A whole-cluster barrier
// (cluster.sync()) costs a device-wide memory fence every time; instead each
// value travels as an asynchronous store into the other block's shared
// memory that reports its bytes to a transaction barrier (mbarrier) THERE.
// The receiver posts how many bytes a step brings and waits for them: data
// and signal arrive together, no fence, no cluster-wide rendezvous.  One
// barrier per step of the iteration, one phase of it per iteration.

__device__ __forceinline__ uint32_t shared_addr(const void* ptr)
{
    return (uint32_t)__cvta_generic_to_shared(ptr);
}

// the same place in the shared memory of block `rank` of the cluster
__device__ __forceinline__ uint32_t in_block(uint32_t addr, unsigned rank)
{
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(addr), "r"(rank));
    return remote;
}

__device__ __forceinline__ void barrier_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(shared_addr(bar)) : "memory");
}

// one thread per block and step: `bytes` are on their way into this block
__device__ __forceinline__ void barrier_expect(uint64_t* bar, unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(shared_addr(bar)), "r"(bytes) : "memory");
}

// every thread: until the step's bytes have all arrived.  A count that never
// completes (a bug) ends the launch with an error instead of hanging it.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned parity)
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
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
    }
    __trap();
}

// value -> element `idx` of the copy of `ptr` in every block of the cluster,
// counted by the copy of `bar` there
__device__ __forceinline__ void store_all(unsigned C, float* ptr, int idx,
                                          float value, uint64_t* bar)
{
    const uint32_t dst = shared_addr(ptr + idx), sig = shared_addr(bar);
    for (unsigned c = 0; c < C; ++c)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
            "[%0], %1, [%2];\n"
            :: "r"(in_block(dst, c)), "f"(value), "r"(in_block(sig, c))
            : "memory");
}

// ... and its NS parts -> element `idx` of every block's copy of `v`
template <int NS>
__device__ __forceinline__ void store_split_all(unsigned C, const SplitVec& v,
                                                int idx, float value,
                                                uint64_t* bar)
{
    uint32_t p[NS];
    split_tf32<NS>(value, p);
#pragma unroll
    for (int s = 0; s < NS; ++s)
        store_all(C, v.parts, s * v.stride + idx, __uint_as_float(p[s]), bar);
}

__global__ void __launch_bounds__(512)
admm_mma_cluster_kernel(IterArgs a, int ld, int rows_n, int rows_m,
                        int resident)
{
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / C;
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int warp = t >> 5;
    const int n_warps = T >> 5;
    const int n = a.n, m = a.m;
    const int np = pad16(n);
    const int out_pad = np > rows_m ? np : rows_m;
    // this block's rows of K^-1 and K, and of A
    const int n0 = min(n, rank * rows_n);
    const int nc = min(n, n0 + rows_n) - n0;
    const int m0 = min(m, rank * rows_m);
    const int mc = min(m, m0 + rows_m) - m0;

    // vectors, each zero-padded to a multiple of 16 (the B operand reads
    // whole 16-deep chunks)
    const int vec_floats = cluster_vec_floats(n, rows_m, C);
    for (int k = t; k < vec_floats; k += T) smem[k] = 0.f;
    float* p = smem;
    float* x = p;    p += np;
    float* q = p;    p += np;
    float* rhs = p;  p += np;
    float* xa = p;   p += np;
    float* xt = p;   p += np;
    // what the products read: the TF32 parts of rhs, x_a, r, x_t and w
    const SplitVec rhs_s = {p, np};  p += PARTS * np;
    const SplitVec xa_s = {p, np};   p += RESID_PARTS * np;
    const SplitVec r_s = {p, np};    p += PARTS * np;
    const SplitVec xt_s = {p, np};   p += PARTS * np;
    IterVecs v;      // this block's rows of the m-vectors
    v.z = p;    p += rows_m;
    v.y = p;    p += rows_m;
    v.w = p;    p += rows_m;
    v.l = p;    p += rows_m;
    v.u = p;    p += rows_m;
    v.rho = p;  p += rows_m;
    v.rinv = p; p += rows_m;
    const SplitVec w_s = {p, rows_m};  p += PARTS * rows_m;
    float* part = p; p += MAX_KSPLIT * out_pad;
    float* atw = p;  p += C * np;     // slot c: block c's partial A_c' w_c
    uint64_t* bars = reinterpret_cast<uint64_t*>(p);  p += BARRIER_FLOATS;
    __syncthreads();
    if (t == 0) {
        for (int k = 0; k < N_STEPS; ++k) barrier_init(bars + k);
        // visible to the other blocks' asynchronous stores after the
        // cluster barrier below
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }

    // this block's slices: resident in shared memory (stride ld) or read from
    // device memory every iteration (stride n)
    const float* Kinv_p = a.Kinv + (size_t)b * n * n + (size_t)n0 * n;
    const float* A_p = a.A + (size_t)b * m * n + (size_t)m0 * n;
    const float* K_p = a.K + (size_t)b * n * n + (size_t)n0 * n;
    int ld_kinv = n, ld_a = n, ld_k = n;
    if (resident & RES_KINV) {
        load_rows(p, ld, Kinv_p, nc, n, t, T);
        Kinv_p = p;
        ld_kinv = ld;
        p += rows_n * ld;
    }
    if (resident & RES_A) {
        load_rows(p, ld, A_p, mc, n, t, T);
        A_p = p;
        ld_a = ld;
        p += rows_m * ld;
    }
    if (resident & RES_K) {
        load_rows(p, ld, K_p, nc, n, t, T);
        K_p = p;
        ld_k = ld;
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
        v.z[i] = zi;
        v.y[i] = yi;
        v.l[i] = a.l[gi];
        v.u[i] = a.u[gi];
        v.rho[i] = rh;
        v.rinv[i] = 1.0f / rh;
        v.w[i] = rh * zi - yi;
        store_split<PARTS>(w_s, i, v.w[i]);
    }
    // every block of the cluster is running and loaded: from here on they
    // store into each other
    cp_async_wait();
    cluster.sync();

    const int s_atw = pick_ksplit(n, mc, n_warps);   // A_r' w_r: n out, mc deep
    const int s_nn = pick_ksplit(nc, n, n_warps);    // K^-1 ., K .: nc out
    const int s_ax = pick_ksplit(mc, n, n_warps);    // A_r x_t: mc out, n deep
    const float sigma = a.sigma, alpha = a.alpha;
    const float one_m_alpha = 1.0f - alpha;
    auto to_part = [&](int ks, int o, float acc) {
        part[ks * out_pad + o] = acc;
    };

    // bytes that each step brings into this block, from all blocks together
    const unsigned bytes_atw = 4u * C * n, bytes_xa = 4u * RESID_PARTS * n,
                   bytes_r = 4u * PARTS * n, bytes_xt = 4u * (1 + PARTS) * n;
    for (int it = 0; it < a.iters; ++it) {
        const unsigned phase = it & 1;
        // rhs = sigma x - q + sum over the blocks of A_c' w_c, in rank order
        mma_matvec<PARTS, true>(A_p, ld_a, n, mc, w_s, s_atw, warp, n_warps,
                                to_part);
        __syncthreads();
        if (t == 0) barrier_expect(bars + 0, bytes_atw);
        for (int j = t; j < n; j += T)
            store_all(C, atw, rank * np + j,
                      sum_partials(part, out_pad, s_atw, j), bars + 0);
        barrier_wait(bars + 0, phase);
        for (int j = t; j < n; j += T) {
            float s = atw[j];
            for (int c = 1; c < C; ++c) s += atw[c * np + j];
            rhs[j] = (sigma * x[j] - q[j]) + s;
            store_split<PARTS>(rhs_s, j, rhs[j]);
        }
        __syncthreads();

        // this block's rows of x_a = K^-1 rhs, to every block
        mma_matvec<PARTS, false>(Kinv_p, ld_kinv, nc, n, rhs_s, s_nn, warp,
                                 n_warps, to_part);
        __syncthreads();
        if (t == 0) barrier_expect(bars + 1, bytes_xa);
        for (int i = t; i < nc; i += T) {
            xa[n0 + i] = sum_partials(part, out_pad, s_nn, i);
            store_split_all<RESID_PARTS>(C, xa_s, n0 + i, xa[n0 + i],
                                         bars + 1);
        }
        barrier_wait(bars + 1, phase);

        // ... of r = rhs - K x_a   (K as given)
        mma_matvec<RESID_PARTS, false>(K_p, ld_k, nc, n, xa_s, s_nn, warp,
                                       n_warps, to_part);
        __syncthreads();
        if (t == 0) barrier_expect(bars + 2, bytes_r);
        for (int i = t; i < nc; i += T)
            store_split_all<PARTS>(
                C, r_s, n0 + i,
                rhs[n0 + i] - sum_partials(part, out_pad, s_nn, i), bars + 2);
        barrier_wait(bars + 2, phase);

        // ... of x_t = x_a + K^-1 r; then every block updates its whole x
        mma_matvec<PARTS, false>(Kinv_p, ld_kinv, nc, n, r_s, s_nn, warp,
                                 n_warps, to_part);
        __syncthreads();
        if (t == 0) barrier_expect(bars + 3, bytes_xt);
        for (int i = t; i < nc; i += T) {
            const float xti = xa[n0 + i] + sum_partials(part, out_pad, s_nn, i);
            store_all(C, xt, n0 + i, xti, bars + 3);
            store_split_all<PARTS>(C, xt_s, n0 + i, xti, bars + 3);
        }
        barrier_wait(bars + 3, phase);
        for (int j = t; j < n; j += T)
            x[j] = alpha * xt[j] + one_m_alpha * x[j];

        // z_t = A_r x_t and the projection: this block's rows only
        mma_matvec<PARTS, false>(A_p, ld_a, mc, n, xt_s, s_ax, warp, n_warps,
                                 to_part);
        __syncthreads();
        for (int i = t; i < mc; i += T) {
            project_row(v, i, sum_partials(part, out_pad, s_ax, i), alpha,
                        one_m_alpha);
            store_split<PARTS>(w_s, i, v.w[i]);
        }
        __syncthreads();
    }

    if (rank == 0)
        for (int j = t; j < n; j += T) a.x_out[(size_t)b * n + j] = x[j];
    for (int i = t; i < mc; i += T) {
        a.z_out[(size_t)b * m + m0 + i] = v.z[i];
        a.y_out[(size_t)b * m + m0 + i] = v.y[i];
    }
    // no block leaves while a neighbour may still store into it
    cluster.sync();
}

}  // namespace

extern "C" {

// Launch on `stream` with the geometry of the wrapper's mma_layout():
//   g > 0:   the warp path, g scenarios (warps) per block;
//   g == 0:  the cluster path, `cluster` blocks of `threads` threads per
//            scenario, `resident` saying which slices live in shared memory.
// `ld` is the row stride in shared memory, `smem_floats` the floats of
// shared memory per block as the wrapper reckoned them (checked here).
// Returns the CUDA error code of the launch (0 = success).
int admm_mma_launch(const float* Kinv, const float* K, const float* A,
                    const float* q, const float* l, const float* u,
                    const float* rho, const float* x0, const float* z0,
                    const float* y0, float* x_out, float* z_out, float* y_out,
                    int B, int n, int m, int iters, float sigma, float alpha,
                    int g, int cluster, int threads, int ld, int resident,
                    int smem_floats, void* stream)
{
    if (B <= 0 || n <= 0 || m <= 0 || iters < 0 || (ld & 3) != 0 ||
        ld < ((n + 3) & ~3))
        return (int)cudaErrorInvalidValue;

    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;

    const IterArgs args = {Kinv, K, A, q, l, u, rho, x0, z0, y0,
                           x_out, z_out, y_out, B, n, m, iters, sigma, alpha};
    const size_t smem = sizeof(float) * (size_t)smem_floats;
    if (smem_floats <= 0 || smem > (size_t)max_smem)
        return (int)cudaErrorInvalidValue;

    if (g > 0) {
        if (g > MAX_WARP_SLOTS || smem_floats != g * warp_slot_floats(n, m, ld))
            return (int)cudaErrorInvalidValue;
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(
                admm_mma_warp_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        admm_mma_warp_kernel<<<(B + g - 1) / g, 32 * g, smem,
                               (cudaStream_t)stream>>>(args, ld);
        return (int)cudaGetLastError();
    }

    if (cluster < 1 || cluster > MAX_CLUSTER || threads < 32 ||
        threads > 512 || (threads & 31) != 0 || resident < 0 || resident > 7)
        return (int)cudaErrorInvalidValue;
    // whole 16-row tiles per block
    const int rows_n = (((n + 15) / 16 + cluster - 1) / cluster) * 16;
    const int rows_m = (((m + 15) / 16 + cluster - 1) / cluster) * 16;
    int want = cluster_vec_floats(n, rows_m, cluster);
    if (resident & RES_KINV) want += rows_n * ld;
    if (resident & RES_A) want += rows_m * ld;
    if (resident & RES_K) want += rows_n * ld;
    if (smem_floats != want) return (int)cudaErrorInvalidValue;

    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(admm_mma_cluster_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)B * (unsigned)cluster, 1, 1);
    config.blockDim = dim3((unsigned)threads, 1, 1);
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, admm_mma_cluster_kernel, args, ld,
                             rows_n, rows_m, resident);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* admm_mma_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
