// Device code shared by the kernels whose blocks work on one scenario as a
// thread-block cluster, and their asynchronous loads.
//
// Who shares what:
//   * the exchange (shared_addr, in_block, barrier_init, barrier_expect,
//     barrier_wait, store_all, store4_all): the cluster paths of the
//     tensor-core iteration kernel (admm_mma.cu) and of the M2 iteration
//     kernel (admm_m2.cu);
//   * the asynchronous loads (cp_async4, cp_async16, cp_async_wait,
//     load_rows): admm_mma.cu, admm_m2.cu, the warp path of the generic
//     iteration kernel (admm_vpu.cu) and admm_packed.cu (cp_async4).
//
// The exchange.  A whole-cluster barrier (cluster.sync()) costs a device-wide
// memory fence every time; instead each value travels as an asynchronous
// store into the other block's shared memory that reports its bytes to a
// transaction barrier (mbarrier) THERE.  The receiver posts how many bytes a
// step brings and waits for them: data and signal arrive together, no fence,
// no cluster-wide rendezvous.  One barrier per step of an iteration, one
// phase of it per iteration.  Two rules keep it safe without a second
// barrier: a block issues a step's stores only after it has received the
// step before (so every block has finished reading what the new stores
// overwrite), and no block stores into a neighbour before the first or after
// the last cluster.sync() of the kernel (a store into a block that has not
// started or has left faults the launch).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster_exchange {

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

// four values -> ptr[idx .. idx + 3] (16-byte aligned) in block `rank`,
// counted (16 bytes) by the copy of `bar` there
__device__ __forceinline__ void store4_to(unsigned rank, float* ptr, int idx,
                                          float4 v, uint64_t* bar)
{
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n"
        :: "r"(in_block(shared_addr(ptr + idx), rank)), "f"(v.x), "f"(v.y),
           "f"(v.z), "f"(v.w), "r"(in_block(shared_addr(bar), rank))
        : "memory");
}

// ... into every block of the cluster
__device__ __forceinline__ void store4_all(unsigned C, float* ptr, int idx,
                                           float4 v, uint64_t* bar)
{
    for (unsigned c = 0; c < C; ++c) store4_to(c, ptr, idx, v, bar);
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
// with the row stride ld (a multiple of four), asynchronously, by threads
// t, t + T, ...; the pad columns are zeroed.  Call cp_async_wait() before
// the barrier that publishes the rows.
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

}  // namespace cluster_exchange
