// H3: mxu2 routing.
//
// Replaces lz4tpu/device/mxu2.py::_make_kernel (K4, pallas_call at
// :281); its spec is _pack_chain + the kernel body (mxu2.py:71-109,
// :184-262).  Each output byte has one int32 code from the host packer:
// bit 16 set -> the ring byte at code & 0xFFFF (a byte of an earlier
// substep), bit 16 clear -> the known byte (code >> 17) & 255.  After
// each 2 KiB substep its bytes are written into ring rows scal[i].
//
// Bound on an H100: the serial substep loop of one chain runs on one
// SM (two block barriers and a dependent shared-memory gather per
// substep); device memory sees 4 B of code in and 1 B out per byte.
// Design: one block per chain segment with the 64 KiB ring in dynamic
// shared memory for the whole loop; each thread reads one 16-byte code
// vector per substep and stores its 4 bytes as one 32-bit word.  The
// TPU's paired one-hot matmul routing is not needed: a shared-memory
// gather reads any ring byte directly.
#include "common.cuh"

namespace {

using namespace lz4t;

__device__ __forceinline__ uint32_t decode(int c, const uint8_t* ring) {
  const uint32_t u = uint32_t(c);
  return (u >> 16) & 1u ? ring[u & 0xFFFFu] : (u >> 17) & 255u;
}

// segs[3*s..3*s+2] = (first substep, end substep, carry ring_in)
__global__ void __launch_bounds__(ROUTE_THREADS)
mxu2_route_kernel(const int4* __restrict__ code,
                  const int32_t* __restrict__ scal,
                  const int32_t* __restrict__ segs,
                  const uint8_t* __restrict__ ring_in,
                  uint8_t* __restrict__ out, uint8_t* __restrict__ ring_out,
                  int n_seg) {
  extern __shared__ uint4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int lo = segs[3 * s];
  const int hi = segs[3 * s + 1];
  ring_init(smem4, ring_in, segs[3 * s + 2] != 0 && ring_in != nullptr);

  for (int i = lo; i < hi; ++i) {
    const int4 c = code[size_t(i) * (SUB / 4) + t];
    __syncthreads();  // last substep's ring rows are written
    const uint32_t val = decode(c.x, ring) | decode(c.y, ring) << 8 |
                         decode(c.z, ring) << 16 | decode(c.w, ring) << 24;
    __syncthreads();  // every gather of this substep read the old ring
    const int row = scal[i] & 255;
    reinterpret_cast<uint32_t*>(ring + row * ROWB)[t] = val;
    reinterpret_cast<uint32_t*>(out + size_t(i) * SUB)[t] = val;
  }
  __syncthreads();
  if (s == n_seg - 1) ring_store(smem4, ring_out);
}

}  // namespace

LZ4T_API int lz4t_mxu2_route(const int32_t* code, const int32_t* scal,
                             const int32_t* segs, int n_seg,
                             const uint8_t* ring_in, uint8_t* out,
                             uint8_t* ring_out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mxu2_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (e != cudaSuccess) return int(e);
  if (n_seg > 0)
    mxu2_route_kernel<<<n_seg, ROUTE_THREADS, RING,
                        static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const int4*>(code), scal, segs, ring_in, out,
        ring_out, n_seg);
  return int(cudaGetLastError());
}
