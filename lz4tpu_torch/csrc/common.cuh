// Shared constants and the C-interface export macro of the port's kernels.
//
// Every entry point is a plain C function: pointers, sizes and the CUDA
// stream come in from Python through ctypes (lz4tpu_torch/_kernels.py),
// the kernel is launched on that stream, and the function returns
// cudaGetLastError() so that a refused launch surfaces at the call site.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LZ4T_API extern "C" __attribute__((visibility("default")))

namespace lz4t {

constexpr int SUB = 2048;          // output bytes per substep
constexpr int RING = 65536;        // LZ4 history window: the ring
constexpr int ROWB = 256;          // ring row bytes (prep row indices)
constexpr int WIN = 4096;          // fused literal window per substep
constexpr int WIN_STRIDE = 8192;   // bytes per prepared literal window
constexpr int ROUTE_THREADS = SUB / 4;  // route kernels: 4 bytes a thread

// Zero the block's ring, or load it from ring_in (ring carry).
__device__ __forceinline__ void ring_init(uint4* ring4, const uint8_t* ring_in,
                                          bool carry) {
  const uint4* src = reinterpret_cast<const uint4*>(ring_in);
  for (int k = threadIdx.x; k < RING / 16; k += blockDim.x)
    ring4[k] = carry ? src[k] : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void ring_store(const uint4* ring4, uint8_t* ring_out) {
  uint4* dst = reinterpret_cast<uint4*>(ring_out);
  for (int k = threadIdx.x; k < RING / 16; k += blockDim.x) dst[k] = ring4[k];
}

// Four bytes of shared memory at byte offsets u0..u3 from `sm`, packed
// little-endian: the route kernels' gather.  Four one-byte loads: on this
// card a route's substep is bound by the instructions its warps execute and
// by its barriers before it is bound by shared-memory wavefronts, and a
// gather of aligned words (two 32-bit loads, byte extraction, a one-byte
// load for what lies outside) measured slower than this.
__device__ __forceinline__ uint32_t gather4(const uint8_t* sm, int u0, int u1,
                                            int u2, int u3) {
  return uint32_t(sm[u0]) | uint32_t(sm[u1]) << 8 | uint32_t(sm[u2]) << 16 |
         uint32_t(sm[u3]) << 24;
}

// 16 bytes from device memory to shared memory without passing through
// registers; completion is awaited per group (cp_async_wait).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   unsigned(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are
// still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

}  // namespace lz4t

LZ4T_API const char* lz4t_error_string(int status);
