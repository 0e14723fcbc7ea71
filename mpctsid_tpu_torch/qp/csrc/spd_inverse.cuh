// The Jacobi-scaled Cholesky inverse with one guarded Newton-Schulz step, ONE
// WARP per matrix (n <= 32) — device code shared by
//   * the warp path of the whole-solve kernel (admm_fused.cu: kernel 4,
//     backend "fused", and the plain backend's solve, admm_plain_warp_kernel),
//     once per adapt round, and
//   * the warp path of the SPD-inverse kernel (spd_inverse.cu), K^-1 of the
//     kernel backends' WBC solves.
// It is written once, here, in two halves (the factorization, then X0 and
// the Newton-Schulz step: `warp_x0_newton`).  Kernel A runs its own
// factorization (`warp_chol_inverse`, the register sweep that the block path
// of spd_inverse.cu runs on its diagonal blocks) and then the second half.
//
// The function (qp/blockinv.py::spd_inverse_chol with ns_steps = 1):
//   s = rsqrt(max(diag K, 1e-30))  (the caller's, passed in as `si`),
//   Ks = s K s, L = chol(Ks) with the 1e-10 pivot floor, X0 = L^-T L^-1,
//   X = X0 (2 I - Ks X0), kept only if |I - Ks X|_F^2 < 4 |I - Ks X0|_F^2 + 1
//   (a NaN compares false: back to X0); "bad" when the kept X is not finite
//   (the caller then takes the identity); K^-1 = s X s (the caller's).
//
// Layout: lane i owns row i of the n x n matrices.  The scratch matrix W is
// n rows of WS = 32 floats, 16-byte aligned, and holds TRANSPOSES: a lane
// stores entry (i, j) of its row at W[j][i] (lanes on consecutive words), so
// that what every lane reads alike is a ROW of W, eight 16-byte broadcasts
// instead of thirty 4-byte loads (the warp's time goes into shared-memory
// load instructions: PERF.md, kernel 4).
//   - Row `lane` of Ks stays in registers for the Newton-Schulz step.
//   - Cholesky: a left-looking column sweep, lane i on row i, L' into W, the
//     pivot broadcast by a shuffle, one __syncwarp() per column.  L^-1 by
//     forward substitution, lane c on column c, row-major into the lower
//     triangle of W while L' still sits above the diagonal.
//   - X0 = L^-T L^-1: row i in registers (rows of L^-1 as 16-byte
//     broadcasts), then X0' over W.  M = 2 I - Ks X0 and X = X0 M column by
//     column, the left operand's row in registers, each result written over
//     the row of W just read.  |I - Ks X|^2 the same way, reduced on the fly.

#pragma once

#include <cuda_runtime.h>

#include "admm_block.cuh"
#include "spd_blocked.h"

namespace spd_warp {

constexpr int WN = 32;              // largest n: lane i owns row and column i
constexpr int WS = 32;              // row stride of the scratch matrix W
constexpr unsigned FULL = 0xffffffffu;

// sum_r row[r] * wrow[r] over all WS entries: the row in registers, wrow a
// row of W read by every lane alike in eight 16-byte broadcasts.  Entries
// past n are zero on both sides.
__device__ __forceinline__ float row_dot(const float (&row)[WN],
                                         const float* wrow)
{
    const float4* w4 = reinterpret_cast<const float4*>(wrow);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int q = 0; q < WS / 4; ++q) {
        const float4 v = w4[q];
        a0 = fmaf(row[4 * q + 0], v.x, a0);
        a1 = fmaf(row[4 * q + 1], v.y, a1);
        a2 = fmaf(row[4 * q + 2], v.z, a2);
        a3 = fmaf(row[4 * q + 3], v.w, a3);
    }
    return (a0 + a1) + (a2 + a3);
}

// The Cholesky factor of a 32 x 32 block held one row per lane (r: row
// `lane`, the entries past the diagonal ignored; pivots under 1e-10 floored,
// spd_blocked.h) and its inverse in ONE sweep: per column j the pivot comes
// by a shuffle from lane j, lane i forms L[i][j] from the column's one
// reciprocal (the same in every lane, spd_blocked::div_by) and entry (j, i)
// of L^-1 (lane c forms
// column c; its partial sums acc[k] = sum_{j<k} L[k][j] L^-1[j][c] stay in
// registers), and the one shuffle per row k > j that brings L[k][j] serves
// both lane i's update of its row and the partial sums.  Row j of L^-1
// (zeros above the diagonal) goes to D[j * ld], for j < rows.  The block
// path of spd_inverse.cu runs it on each diagonal block, kernel A on Ks
// with an identity pad; spd_blocked.h's diag_factor_host is this
// arithmetic lane after lane.
__device__ __forceinline__ void warp_chol_inverse(float (&r)[WN], float* D,
                                                  int ld, int rows, int lane)
{
    float acc[WN];
#pragma unroll
    for (int k = 0; k < WN; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
        const float d = spd_blocked::pivot_root(__shfl_sync(FULL, r[j], j));
        const float inv_d = 1.0f / d;
        const float l = spd_blocked::column_entry(lane, j, r[j], d, inv_d);
        const float x = spd_blocked::inverse_entry(lane, j, acc[j], d, inv_d);
        if (j < rows) D[j * ld + lane] = x;
#pragma unroll
        for (int k = j + 1; k < WN; ++k) {
            const float lk = __shfl_sync(FULL, l, k);
            if (lane >= k) r[k] = fmaf(-l, lk, r[k]);
            acc[k] = fmaf(lk, x, acc[k]);
        }
    }
}

// The second half of warp_scaled_inverse, on its own for kernel A: W holds
// L^-1 of Ks (rows of WS floats, zeros above the diagonal and past n), ks
// row `lane` of Ks (zero past n and in lanes past n).  X0 = L^-T L^-1, one
// guarded Newton-Schulz step; xr, row `lane` of the kept X; true in every
// lane where it is not finite.  W is free again on return.
__device__ __forceinline__ bool warp_x0_newton(const float (&ks)[WN], int n,
                                               float* sW, int lane,
                                               float (&xr)[WN])
{
    const bool act = lane < n;
    // row `lane` of X0 = L^-T L^-1, in registers, then TRANSPOSED over W
#pragma unroll
    for (int j = 0; j < WN; ++j) xr[j] = 0.f;
    for (int r = 0; r < n; ++r) {
        const float4* lr = reinterpret_cast<const float4*>(sW + r * WS);
        const float li = act ? sW[r * WS + lane] : 0.f;
#pragma unroll
        for (int q = 0; q < WS / 4; ++q) {
            const float4 v = lr[q];
            xr[4 * q + 0] = fmaf(li, v.x, xr[4 * q + 0]);
            xr[4 * q + 1] = fmaf(li, v.y, xr[4 * q + 1]);
            xr[4 * q + 2] = fmaf(li, v.z, xr[4 * q + 2]);
            xr[4 * q + 3] = fmaf(li, v.w, xr[4 * q + 3]);
        }
    }
    __syncwarp();
    if (act) {
#pragma unroll
        for (int j = 0; j < WN; ++j)
            if (j < n) sW[j * WS + lane] = xr[j];
    }
    __syncwarp();

    // one Newton-Schulz step.  M = 2I - Ks X0 column by column: column j of
    // X0 is row j of W, read by every lane, then overwritten by column j of
    // M;  r0 = |I - Ks X0|_F^2
    float r0 = 0.f;
    for (int j = 0; j < n; ++j) {
        const float acc = row_dot(ks, sW + j * WS);
        const float eye = j == lane ? 1.0f : 0.f;
        const float d = act ? eye - acc : 0.f;
        r0 = fmaf(d, d, r0);
        __syncwarp();
        if (act) sW[j * WS + lane] = 2.0f * eye - acc;
    }
    r0 = admm_block::warp_sum(r0);
    __syncwarp();
    // X = X0 M, the same way over M
    for (int j = 0; j < n; ++j) {
        const float acc = row_dot(xr, sW + j * WS);
        __syncwarp();
        if (act) sW[j * WS + lane] = acc;
    }
    __syncwarp();
    // r1 = |I - Ks X|_F^2
    float r1 = 0.f;
    for (int j = 0; j < n; ++j) {
        const float acc = row_dot(ks, sW + j * WS);
        const float d = act ? (j == lane ? 1.0f : 0.f) - acc : 0.f;
        r1 = fmaf(d, d, r1);
    }
    r1 = admm_block::warp_sum(r1);
    // divergence safeguard (a NaN compares false: back to X0), then the
    // finite test of what is kept
    const bool take_x = r1 < r0 * 4.0f + 1.0f;
    float bad = 0.f;
#pragma unroll
    for (int j = 0; j < WN; ++j)
        if (j < n && act) {
            xr[j] = take_x ? sW[j * WS + lane] : xr[j];
            if (!isfinite(xr[j])) bad += 1.0f;
        }
    bad = admm_block::warp_sum(bad);
    __syncwarp();
    return bad > 0.f;
}

// In:  kr, row `lane` of K (read for j < n); si, the lane's Jacobi scale s
//      (0 in lanes past n); sW, n rows of WS floats of shared memory, 16-byte
//      aligned, the warp's own.
// Out: xr, row `lane` of X in the SCALED frame, the divergence safeguard
//      applied (lanes past n: unspecified); returns true in every lane where
//      X is not finite.  The caller forms K^-1 = s X s (or s I s when bad).
// Every lane of the warp calls; W is free again on return.
__device__ __forceinline__ bool warp_scaled_inverse(const float (&kr)[WN],
                                                    float si, int n,
                                                    float* sW, int lane,
                                                    float (&xr)[WN])
{
    const bool act = lane < n;
    const int own = act ? lane : 0;

    // row `lane` of Ks = s K s, in registers (ks); zero in lanes past n and
    // in columns past n
    float ks[WN];
#pragma unroll
    for (int j = 0; j < WN; ++j) {
        const float sj = __shfl_sync(FULL, si, j);
        ks[j] = j < n ? (kr[j] * sj) * si : 0.f;
    }
    // W is factored with the row stride WS; its columns past n must read as
    // zero (the caller may have left other data there)
    if (act)
        for (int j = n; j < WS; ++j) sW[lane * WS + j] = 0.f;

    // Cholesky, left-looking column sweep: lane i forms entry (i, j) of L and
    // stores it at W[j][i]; the pivot's own sum comes from lane j.  Lanes
    // above the diagonal store zeros.  Lane j keeps L[j][j].
    float diag = 1.0f;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
        if (j < n) {
            float vi = ks[j];
            for (int k = 0; k < j; ++k)
                vi = fmaf(-sW[k * WS + own], sW[k * WS + j], vi);
            const float vj = __shfl_sync(FULL, vi, j);
            const float lij =
                lane >= j ? vi / sqrtf(fmaxf(vj, 1e-10f)) : 0.f;
            if (lane == j) diag = lij;
            if (act) sW[j * WS + lane] = lij;
            __syncwarp();
        }
    }

    // L^-1 by forward substitution, row-major into the lower triangle of W
    // (L' stays above the diagonal until every row has used it): lane c forms
    // column c; entry (i, c) needs row i of L, read by every lane alike from
    // column i of W, and column c of L^-1 above it
    for (int i = 0; i < n; ++i) {
        float acc = 0.f;
        for (int k = 0; k < i; ++k) {
            const float lkc = k >= lane ? sW[k * WS + own] : 0.f;
            acc = fmaf(sW[k * WS + i], lkc, acc);
        }
        const float lii = __shfl_sync(FULL, diag, i);
        if (lane <= i)
            sW[i * WS + lane] = lane == i ? 1.0f / lii : -acc / lii;
        __syncwarp();
    }
    for (int k = 0; k < n; ++k)          // L' has served: zeros above
        if (act && k < lane) sW[k * WS + lane] = 0.f;
    __syncwarp();
    return warp_x0_newton(ks, n, sW, lane, xr);
}

}  // namespace spd_warp
