// H4 xxh32_stream and H5 xxh32_blocks: xxhash32 lane states on the device.
//
// H4 replaces lz4tpu/device/xxh32_pallas.py::_xxh32_kernel (pallas_call at
// :89, seed-0 state) and ::_xxh32_kernel_cont (pallas_call at :198, carried
// state): the four 32-bit lane accumulators over n 16-byte stripes of a
// device-resident byte array, from a caller's state to the state after.
// H5 replaces ::_xxh32_blocks_kernel (pallas_call at :328): the lane states
// of every block (offset, length) of the compressed buffer in one launch.
// The avalanche over the lane state and the <16-byte tail stays on the host.
//
// The TPU kernels' 8 KiB SMEM steps, the fixed 8 MiB segments with their
// zero-padded last part and the step tables of the blocks kernel exist to
// keep one compiled shape and are not carried: one launch covers a whole
// range, starting at any byte offset.
//
// Bound on an H100: the dependent chain.  A lane's update
// s = rotl(s + w * P2, 13) * P1 needs the previous s, so no card can
// overlap one lane's stripes: the least time is stripes x the latency of
// (add, rotate, multiply) at the SM clock, far above the time to read the
// bytes.  Design: keep everything else off that chain.  Warp 0's lanes
// 0..3 each own one accumulator and do only add, rotate, multiply.  The
// block's other warps prepare the next tile of 1024 stripes meanwhile
// (double buffer, one barrier per tile): each loads its stripe from device
// memory as aligned 16-byte vectors, assembles the four little-endian
// words at whatever byte the range starts (two neighbouring vectors and a
// funnel shift), multiplies them by P2, and stores them to shared memory
// one array per lane, so that an accumulator fetches four stripes' terms
// with one 16-byte load.  H5 runs the same loop with one thread block per
// LZ4 block, so independent chains fill the card's SMs.
#include "common.cuh"

namespace {

constexpr uint32_t P1 = 2654435761u;
constexpr uint32_t P2 = 2246822519u;
constexpr int TILE_STRIPES = 1024;            // stripes per shared tile
constexpr int LANE_WORDS = TILE_STRIPES + 4;  // +16 B: lanes on other banks
constexpr int THREADS = 256;                  // warp 0 hashes, 7 warps load

struct Tiles {
  alignas(16) uint32_t wp[2][4][LANE_WORDS];   // [buffer][lane][stripe]:
};                                             // the stripe's word * P2

__device__ __forceinline__ uint32_t round1(uint32_t s, uint32_t wp) {
  return __funnelshift_l(s + wp, s + wp, 13) * P1;
}

// Lane state after n_stripes stripes of data[0 : 16 * n_stripes), starting
// from `s` (meaningful in threads 0..3 of the block; returned there).
// Needs blockDim.x >= 64: warp 0 computes, the other warps load.
__device__ __forceinline__ uint32_t lane_chain(const uint8_t* data,
                                               int64_t n_stripes, uint32_t s,
                                               Tiles& sh) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const int mis = int(addr & 15);
  const uint4* base = reinterpret_cast<const uint4*>(addr - mis);
  const int64_t n_tiles = (n_stripes + TILE_STRIPES - 1) / TILE_STRIPES;
  const int tid = threadIdx.x;
  const int loaders = blockDim.x - 32;
  const int q = mis >> 2;               // whole words to skip
  const int shift = (mis & 3) * 8;      // then bits

  for (int64_t t = -1; t < n_tiles; ++t) {
    if (tid >= 32 && t + 1 < n_tiles) {          // prepare tile t + 1
      const int64_t g0 = (t + 1) * TILE_STRIPES;
      const int64_t left = n_stripes - g0;
      const int n = int(left < TILE_STRIPES ? left : TILE_STRIPES);
      uint32_t (*dst)[LANE_WORDS] = sh.wp[(t + 1) & 1];
      for (int i = tid - 32; i < n; i += loaders) {
        // stripe g0 + i lies in aligned vectors g0 + i and, when the
        // range starts off a 16-byte boundary, g0 + i + 1
        const uint4 a = base[g0 + i];
        const uint4 b = mis ? base[g0 + i + 1] : a;
        const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint32_t y[5];
#pragma unroll
        for (int k = 0; k < 5; ++k)
          y[k] = q == 0 ? x[k] : q == 1 ? x[k + 1] : q == 2 ? x[k + 2]
                                                            : x[k + 3];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[k][i] = __funnelshift_r(y[k], y[k + 1], shift) * P2;
      }
    }
    if (tid < 4 && t >= 0) {                      // hash tile t
      const uint32_t* wp = sh.wp[t & 1][tid];
      const int64_t left = n_stripes - t * TILE_STRIPES;
      const int n = int(left < TILE_STRIPES ? left : TILE_STRIPES);
      // four stripes' terms per 16-byte load, fetched one step ahead of
      // the rounds that use them (the lane's 16 B pad keeps the last
      // prefetch inside its array)
      const uint4* wp4 = reinterpret_cast<const uint4*>(wp);
      uint4 v = wp4[0];
      int i = 0;
#pragma unroll 2
      for (; i + 4 <= n; i += 4) {
        const uint4 nxt = wp4[i / 4 + 1];
        s = round1(round1(round1(round1(s, v.x), v.y), v.z), v.w);
        v = nxt;
      }
      for (; i < n; ++i) s = round1(s, wp[i]);
    }
    __syncthreads();
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
xxh32_stream_kernel(const uint8_t* __restrict__ data, int64_t n_stripes,
                    const int32_t* __restrict__ state_in,
                    int32_t* __restrict__ state_out) {
  __shared__ Tiles sh;
  uint32_t s = threadIdx.x < 4 ? uint32_t(state_in[threadIdx.x]) : 0u;
  s = lane_chain(data, n_stripes, s, sh);
  if (threadIdx.x < 4) state_out[threadIdx.x] = int32_t(s);
}

__global__ void __launch_bounds__(THREADS)
xxh32_blocks_kernel(const uint8_t* __restrict__ comp,
                    const int64_t* __restrict__ offsets,
                    const int64_t* __restrict__ lengths,
                    int32_t* __restrict__ states) {
  __shared__ Tiles sh;
  const int b = blockIdx.x;
  // seed 0: P1 + P2, P2, 0, -P1
  uint32_t s = 0u;
  if (threadIdx.x == 0) s = P1 + P2;
  if (threadIdx.x == 1) s = P2;
  if (threadIdx.x == 3) s = 0u - P1;
  s = lane_chain(comp + offsets[b], lengths[b] / 16, s, sh);
  if (threadIdx.x < 4) states[4 * b + threadIdx.x] = int32_t(s);
}

}  // namespace

LZ4T_API int lz4t_xxh32_stream(const uint8_t* data, int64_t n_stripes,
                               const int32_t* state_in, int32_t* state_out,
                               void* stream) {
  xxh32_stream_kernel<<<1, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      data, n_stripes, state_in, state_out);
  return int(cudaGetLastError());
}

LZ4T_API int lz4t_xxh32_blocks(const uint8_t* comp, const int64_t* offsets,
                               const int64_t* lengths, int n_blocks,
                               int32_t* states, void* stream) {
  if (n_blocks > 0)
    xxh32_blocks_kernel<<<n_blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        comp, offsets, lengths, states);
  return int(cudaGetLastError());
}
