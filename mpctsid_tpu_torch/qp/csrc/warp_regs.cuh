// The refined iteration by ONE warp per scenario with K^-1 and K in
// registers: the loop that kernel 2's warp path (admm_vpu.cu) and kernel 3's
// register path (admm_packed.cu) share, written once so the two cannot drift.
// Both kernels load their scenario their own way and then run
// `warp_register_iterations` on the same slot layout; on the same inputs
// they give the same bits.
//
// The slot of one scenario in shared memory (`carve_slot`): A with round4(m)
// rows of stride ld (a multiple of four, at least 32; the pad rows and
// columns zero), then rhs, x_a, r, x_t (32 floats each, zero past n), then
// w (round4(m), zero past m), z, y, l, u, rho, 1 / rho (round4(m) each).
// Lane i holds row i of K^-1 and column i of K in registers (zero past n)
// and the elements x_i, q_i; the vector operands are read from the slot as
// 16-byte broadcasts, a quarter of a shared-memory instruction per FMA.  A
// stride of 4 mod 8 floats (36) puts the rows that a quarter warp reads in
// 16-byte pieces for A x_t on different banks; A' w reads one row per step,
// lanes on neighbouring columns.  Only what the other lanes read goes to
// shared memory; phases are separated by __syncwarp() only.

#pragma once

#include <cuda_runtime.h>

namespace warp_regs {

constexpr int WARP_N = 32;   // n <= 32: lane i owns row / column i

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// floats of the slot after A's rows: rhs, x_a, r, x_t, then seven m-vectors
__host__ __device__ __forceinline__ int vec_floats(int m)
{
    return 4 * WARP_N + 7 * round4(m);
}

__device__ __forceinline__ float4 f4(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

// sum_k reg[k] vec[k] over 32 entries, vec in 16-byte broadcasts
__device__ __forceinline__ float dot32(const float (&reg)[WARP_N],
                                       const float* vec)
{
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < WARP_N; k += 4) {
        const float4 v = f4(vec + k);
        a0 = fmaf(reg[k], v.x, a0);
        a1 = fmaf(reg[k + 1], v.y, a1);
        a0 = fmaf(reg[k + 2], v.z, a0);
        a1 = fmaf(reg[k + 3], v.w, a1);
    }
    return a0 + a1;
}

// sum_k row[k] vec[k], k < kp (a multiple of four), both in shared memory
__device__ __forceinline__ float dot_row4(const float* row, const float* vec,
                                          int kp)
{
    float a0 = 0.f, a1 = 0.f;
    for (int k = 0; k < kp; k += 4) {
        const float4 r = f4(row + k);
        const float4 v = f4(vec + k);
        a0 = fmaf(r.x, v.x, a0);
        a1 = fmaf(r.y, v.y, a1);
        a0 = fmaf(r.z, v.z, a0);
        a1 = fmaf(r.w, v.w, a1);
    }
    return a0 + a1;
}

struct Slot {
    float *A, *rhs, *xa, *r, *xt, *w, *z, *y, *l, *u, *rho, *rinv;
};

// The slot's pieces; A's region holds `a_floats` floats (at least
// round4(m) * ld, a multiple of four).
__device__ __forceinline__ Slot carve_slot(float* base, int m, int a_floats)
{
    const int mp = round4(m);
    Slot s;
    float* p = base;
    s.A = p;     p += a_floats;
    s.rhs = p;   p += WARP_N;
    s.xa = p;    p += WARP_N;
    s.r = p;     p += WARP_N;
    s.xt = p;    p += WARP_N;
    s.w = p;     p += mp;
    s.z = p;     p += mp;
    s.y = p;     p += mp;
    s.l = p;     p += mp;
    s.u = p;     p += mp;
    s.rho = p;   p += mp;
    s.rinv = p;
    return s;
}

// One scenario's vectors (pointers at the scenario): z, y, l, u, rho,
// 1 / rho and w = rho z - y into the slot (pad rows inert: rho 1, the rest
// 0); returns x_lane and q_lane (zero past n) through x and q.
__device__ __forceinline__ void load_vectors(
    const Slot& s, const float* gq, const float* gl, const float* gu,
    const float* grho, const float* gx0, const float* gz0, const float* gy0,
    int n, int m, int lane, float& x, float& q)
{
    const int mp = round4(m);
    const bool own = lane < n;
    x = own ? gx0[lane] : 0.f;
    q = own ? gq[lane] : 0.f;
    for (int i = lane; i < mp; i += 32) {
        const bool in = i < m;
        const float rh = in ? grho[i] : 1.f;
        const float zi = in ? gz0[i] : 0.f;
        const float yi = in ? gy0[i] : 0.f;
        s.z[i] = zi;
        s.y[i] = yi;
        s.l[i] = in ? gl[i] : 0.f;
        s.u[i] = in ? gu[i] : 0.f;
        s.rho[i] = rh;
        s.rinv[i] = 1.0f / rh;
        s.w[i] = in ? rh * zi - yi : 0.f;
    }
}

// `iters` updates of the refined iteration with K TRANSPOSED
// (admm_block.cuh, `refined_iterations`) by one warp; returns the new x_lane.
// On entry the slot holds A, w, z, y, l, u, rho, 1 / rho and the warp is
// synchronised; on exit z and y are current and the warp is synchronised.
__device__ __forceinline__ float warp_register_iterations(
    const float (&kinv)[WARP_N], const float (&kcol)[WARP_N], const Slot& s,
    int ld, int n, int m, int iters, float sigma, float alpha, float x,
    float q, int lane)
{
    const int mp = round4(m);
    const int kp = round4(n);
    const float one_m_alpha = 1.0f - alpha;
    for (int it = 0; it < iters; ++it) {
        // rhs = sigma x - q + A' w   (lane j: column j of A, w broadcast)
        float a0 = 0.f, a1 = 0.f;
        for (int i = 0; i < mp; i += 4) {
            const float4 wv = f4(s.w + i);
            const float* col = s.A + i * ld + lane;
            a0 = fmaf(col[0], wv.x, a0);
            a1 = fmaf(col[ld], wv.y, a1);
            a0 = fmaf(col[2 * ld], wv.z, a0);
            a1 = fmaf(col[3 * ld], wv.w, a1);
        }
        const float rhs = (sigma * x - q) + (a0 + a1);
        s.rhs[lane] = rhs;
        __syncwarp();
        // x_a = K^-1 rhs   (row `lane` of K^-1)
        const float xa = dot32(kinv, s.rhs);
        s.xa[lane] = xa;
        __syncwarp();
        // r = rhs - K' x_a   (the explicit residual, column `lane` of K)
        s.r[lane] = rhs - dot32(kcol, s.xa);
        __syncwarp();
        // x_t = x_a + K^-1 r;  x <- alpha x_t + (1 - alpha) x
        const float xt = xa + dot32(kinv, s.r);
        s.xt[lane] = xt;
        x = alpha * xt + one_m_alpha * x;
        __syncwarp();
        // z_t = A x_t, then the z / y / w updates of rows lane, lane + 32, ..
        auto project = [&](int i, float zt) {
            const float zr = alpha * zt + one_m_alpha * s.z[i];
            const float yi = s.y[i];
            const float rh = s.rho[i];
            const float zn =
                fminf(fmaxf(zr + s.rinv[i] * yi, s.l[i]), s.u[i]);
            const float yn = yi + rh * (zr - zn);
            s.z[i] = zn;
            s.y[i] = yn;
            s.w[i] = rh * zn - yn;
        };
        for (int i = lane; i < m; i += 32)
            project(i, dot_row4(s.A + i * ld, s.xt, kp));
        __syncwarp();
    }
    return x;
}

// x, z, y of one scenario (pointers at the scenario) from the lane and slot
__device__ __forceinline__ void store_results(const Slot& s, float x,
                                              float* gx, float* gz, float* gy,
                                              int n, int m, int lane)
{
    if (lane < n) gx[lane] = x;
    for (int i = lane; i < m; i += 32) {
        gz[i] = s.z[i];
        gy[i] = s.y[i];
    }
}

}  // namespace warp_regs
