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

}  // namespace lz4t

LZ4T_API const char* lz4t_error_string(int status);
