// The shared-memory slot of one scenario in the packed iteration kernel
// (admm_packed.cu), in floats.  Plain C++: the kernel's library exports it
// (`admm_packed_slot_floats`), the Python wrapper sizes its launches with
// that export, and the CPU tests build this header with the host compiler to
// hold the layout function to the same count.  Nothing else keeps a copy.
//
//   REGISTER path (n <= 32): K^-1 and K live in registers.  A's region holds
//     A at the row stride REG_LD (round4(m) rows) and, before A arrives, the
//     two matrices on their way to the registers (n rows of stride n | 1
//     each), whichever is larger; then the vectors of warp_regs.cuh: rhs,
//     x_a, r, x_t (32 each) and seven m-vectors (round4(m) each).
//   SHARED path (n > 32): K^-1, K and A with the odd row stride n | 1, and
//     5 n + 7 m vector entries, as admm_block.cuh's warp loop reads them.

#pragma once

#ifdef __CUDACC__
#define PACKED_SLOT_FN __host__ __device__ __forceinline__
#else
#define PACKED_SLOT_FN inline
#endif

namespace packed_slot {

constexpr int PATH_SHARED = 0;
constexpr int PATH_REGISTERS = 1;
constexpr int REG_N = 32;    // the register path: lane i owns row / column i
constexpr int REG_LD = 36;   // A's row stride there: 4 mod 8, at least 32

PACKED_SLOT_FN int round4(int v) { return (v + 3) & ~3; }

// one matrix on its way to the registers: n rows of the odd stride n | 1
PACKED_SLOT_FN int stage_floats(int n) { return round4(n * (n | 1)); }

// A's region on the register path
PACKED_SLOT_FN int reg_a_floats(int n, int m)
{
    const int a = round4(m) * REG_LD;
    const int stage = 2 * stage_floats(n);
    return a > stage ? a : stage;
}

// floats of one scenario's slot on `path`; -1 for a shape the path does not
// take (n > 32 on the register path)
PACKED_SLOT_FN int slot_floats(int path, int n, int m)
{
    if (path == PATH_REGISTERS)
        return n <= REG_N ? reg_a_floats(n, m) + 4 * REG_N + 7 * round4(m)
                          : -1;
    return (2 * n + m) * (n | 1) + 5 * n + 7 * m;
}

}  // namespace packed_slot
