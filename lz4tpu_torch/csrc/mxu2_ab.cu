// H7: mxu2 routing with the substep size as a parameter, and timing-only
// ablations of the loop's phases (the A/B harness kernel).
//
// Replaces exp/ab.py::make_kernel (K9, pallas_call at :197, launcher
// run_variant :188).  The function is H3's (mxu2.cu) with SUB a template
// parameter: output byte j of substep i is the known byte (code >> 17) &
// 255, or, with bit 16 set, the ring byte at code & 0xFFFF; after each
// substep its SUB bytes are written into the ring at byte offset
// (i * SUB) mod 65536, wrapping past the ring's end when SUB does not
// divide 65536 (3072, 6144, 12288).  K9's row width (rowb) and bytes
// per bf16 digit (pack) are the TPU's one-hot routing and have no
// counterpart here: a shared-memory gather reads any ring byte.  K9's
// scal column holds exactly (i * SUB / rowb) mod pages, so the offset is
// computed from i.
//
// Bound on an H100: as H3, one chain is a serial loop on one SM; device
// memory sees 4 B of code in and 1 B out per byte.  Per substep the loop
// pays the code load from device memory, a barrier, a dependent
// shared-memory gather, a barrier, the ring write and the output store.
// Larger SUB spreads the two barriers and the load latency over more
// bytes; PREFETCH issues substep i+1's code load before substep i's
// gather.  The ablations drop one phase each to show what it costs; their
// output is not the decode and is never compared.
#include "common.cuh"

namespace {

using namespace lz4t;

enum Variant {
  EXACT = 0,       // the decode
  PREFETCH = 1,    // the decode, next substep's code loaded one ahead
  NOGATHER = 2,    // timing only: known byte for every code, no ring read
  NORING = 3,      // timing only: no ring write-back
  NOSTORE = 4,     // timing only: no store of the output bytes
  NOGATHER1B = 5,  // NOGATHER with the second barrier dropped
  NORING1B = 6,    // NORING with the second barrier dropped
  N_VARIANTS = 7,
};

template <int V>
__device__ __forceinline__ uint32_t decode(int c, const uint8_t* ring) {
  const uint32_t u = uint32_t(c);
  if (V == NOGATHER || V == NOGATHER1B) return (u >> 17) & 255u;
  return (u >> 16) & 1u ? ring[u & 0xFFFFu] : (u >> 17) & 255u;
}

// One block decodes one chain of n_sub substeps of SUB_ bytes; thread t
// owns the 4-byte words t, t + THREADS, ... of every substep.
template <int SUB_, int THREADS, int V>
__global__ void __launch_bounds__(THREADS)
route_ab_kernel(const int4* __restrict__ code,
                const uint8_t* __restrict__ ring_in,
                uint8_t* __restrict__ out, uint8_t* __restrict__ ring_out,
                int n_sub) {
  constexpr int WORDS = SUB_ / 4;
  constexpr int VEC = WORDS / THREADS;
  static_assert(VEC * THREADS == WORDS, "threads must divide the substep");
  constexpr bool TWO_BARRIERS = V != NOGATHER1B && V != NORING1B;
  extern __shared__ uint4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  uint32_t* ringw = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* outw = reinterpret_cast<uint32_t*>(out);
  const int t = threadIdx.x;
  ring_init(smem4, ring_in, ring_in != nullptr);

  int4 c[VEC];
  if (V == PREFETCH && n_sub > 0) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) c[k] = code[t + k * THREADS];
  }
  for (int i = 0; i < n_sub; ++i) {
    int4 cur[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (V == PREFETCH) {
        cur[k] = c[k];
        if (i + 1 < n_sub)
          c[k] = code[size_t(i + 1) * WORDS + t + k * THREADS];
      } else {
        cur[k] = code[size_t(i) * WORDS + t + k * THREADS];
      }
    }
    __syncthreads();  // last substep's ring bytes are written
    uint32_t val[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      val[k] = decode<V>(cur[k].x, ring) | decode<V>(cur[k].y, ring) << 8 |
               decode<V>(cur[k].z, ring) << 16 |
               decode<V>(cur[k].w, ring) << 24;
    if (TWO_BARRIERS)
      __syncthreads();  // every gather of this substep read the old ring
    // SUB_ is a multiple of 1024, so a word never straddles the ring's end
    const uint32_t base = (uint32_t(i) * uint32_t(SUB_) & uint32_t(RING - 1)) >> 2;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int w = t + k * THREADS;
      if (V != NORING && V != NORING1B)
        ringw[(base + w) & (RING / 4 - 1)] = val[k];
      if (V != NOSTORE) outw[size_t(i) * WORDS + w] = val[k];
    }
  }
  __syncthreads();
  ring_store(smem4, ring_out);
}

template <int SUB_, int THREADS, int V>
cudaError_t launch_one(const int32_t* code, int n_sub, const uint8_t* ring_in,
                       uint8_t* out, uint8_t* ring_out, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      route_ab_kernel<SUB_, THREADS, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (e != cudaSuccess) return e;
  route_ab_kernel<SUB_, THREADS, V><<<1, THREADS, RING, stream>>>(
      reinterpret_cast<const int4*>(code), ring_in, out, ring_out, n_sub);
  return cudaGetLastError();
}

template <int SUB_, int THREADS>
cudaError_t launch_sub(int variant, const int32_t* code, int n_sub,
                       const uint8_t* ring_in, uint8_t* out,
                       uint8_t* ring_out, cudaStream_t stream) {
  switch (variant) {
#define LZ4T_AB_CASE(V)                                                   \
  case V:                                                                 \
    return launch_one<SUB_, THREADS, V>(code, n_sub, ring_in, out,        \
                                        ring_out, stream);
    LZ4T_AB_CASE(EXACT)
    LZ4T_AB_CASE(PREFETCH)
    LZ4T_AB_CASE(NOGATHER)
    LZ4T_AB_CASE(NORING)
    LZ4T_AB_CASE(NOSTORE)
    LZ4T_AB_CASE(NOGATHER1B)
    LZ4T_AB_CASE(NORING1B)
#undef LZ4T_AB_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// sub: 2048, 3072, 4096, 6144 or 12288; variant: the Variant enum above.
// ring_in may be null (zero ring).
LZ4T_API int lz4t_mxu2_route_ab(const int32_t* code, int n_sub, int sub,
                                int variant, const uint8_t* ring_in,
                                uint8_t* out, uint8_t* ring_out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sub) {
    case 2048:
      return int(launch_sub<2048, 512>(variant, code, n_sub, ring_in, out,
                                       ring_out, s));
    case 3072:
      return int(launch_sub<3072, 768>(variant, code, n_sub, ring_in, out,
                                       ring_out, s));
    case 4096:
      return int(launch_sub<4096, 1024>(variant, code, n_sub, ring_in, out,
                                        ring_out, s));
    case 6144:
      return int(launch_sub<6144, 768>(variant, code, n_sub, ring_in, out,
                                       ring_out, s));
    case 12288:
      return int(launch_sub<12288, 1024>(variant, code, n_sub, ring_in, out,
                                         ring_out, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
