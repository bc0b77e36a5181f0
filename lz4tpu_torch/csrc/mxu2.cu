// H3: mxu2 routing, every byte resolved in parallel by pointer jumping.
//
// Replaces lz4tpu/device/mxu2.py::_make_kernel (K4, pallas_call at
// :281); its spec is _pack_chain + the kernel body (mxu2.py:71-109,
// :184-262) and, in the port, device/mxu2.py::route_plain.  Each output
// byte has one int32 code from the host packer: bit 16 set -> the ring
// byte at code & 0xFFFF, bit 16 clear -> the known byte (code >> 17) &
// 255.  After each 2 KiB substep its bytes are written into ring rows
// scal[i] .. scal[i] + 7, and pack_dense2 advances that row by 8 a
// substep: substep i owns the ring's 2 KiB block (scal[i] & 255) / 8 of
// 32.  So the byte a ring reference reads is known without the walk:
// the one written at that offset by substep i - 1 - ((blk_i - b - 1) &
// 31) (b = offset / 2048), or the segment's initial ring (ring_in where
// the segment carries, else 0) if that substep lies before the segment.
//
// Bound on an H100: bytes.  Device memory sees 4 B of code in and 1 B
// out a byte (the passes' state traffic stays in L2 for a few MiB).  The
// serial walk this replaces ran each chain's substeps in order on one
// SM (two block barriers and a dependent byte gather a substep, 131 of
// 132 SMs idle on one chain).  Design: one thread per 4 bytes over the
// whole card, in three kernels on the caller's stream.
//   sources: one block a substep decodes each code into a state word
//     (>= 0: the absolute position, substep * 2048 + byte, of the byte it
//     equals; < 0: the resolved byte ~s).
//   jump (passes 1..P): every pointer s becomes state[s] in place.  A
//     write only replaces a pointer by one further along the same chain or
//     by its byte, so racing readers see a valid word either way.  Every
//     pointer goes to an earlier substep of its segment, so a chain has
//     fewer than n links and P = ceil(log2(n)) + 1 passes resolve it; a
//     pass returns at once when the last one left nothing unresolved, and
//     a 16-byte word with no pointer left is not stored again.
//   out: the bytes of every word into rows, and ring_out from the last
//     segment's last 32 substeps, ring_in or zeros below them.
// Scratch, from the wrapper: 4 B a byte of state (peak device memory rises
// by the code array's size) and P + 1 flags.
#include <algorithm>

#include "common.cuh"

namespace {

using namespace lz4t;

constexpr int JUMP_THREADS = 256;
constexpr int JUMP_BLOCKS_PER_SM = 8;   // a full SM at <= 32 registers
constexpr int WORDS = SUB / 4;          // int4 state words a substep
constexpr int RING_BLOCKS = RING / SUB; // 32 substeps of history

// Segment row of substep i: the last one with lo <= i (rows are in
// substep order, as ring.part_segments makes them); -1 if none.
__device__ __forceinline__ int segment_of(const int32_t* segs, int n_seg,
                                          int i) {
  int a = -1, b = n_seg;
  while (b - a > 1) {
    const int m = (a + b) >> 1;
    if (segs[3 * m] <= i) a = m;
    else b = m;
  }
  return a;
}

// The state word of code c in substep i (ring block blk) of a segment
// starting at substep lo with initial ring init (nullptr: zeros).
__device__ __forceinline__ int source(int c, int i, int lo, int blk,
                                      const uint8_t* init) {
  const uint32_t u = uint32_t(c);
  if (!((u >> 16) & 1u)) return ~int((u >> 17) & 255u);
  const int o = int(u & 0xFFFFu);
  const int k = i - 1 - ((blk - (o >> 11) - 1) & (RING_BLOCKS - 1));
  if (k >= lo) return k * SUB + (o & (SUB - 1));
  return ~int(init ? init[o] : 0);
}

__global__ void __launch_bounds__(ROUTE_THREADS)
mxu2_sources_kernel(const int4* __restrict__ code,
                    const int32_t* __restrict__ scal,
                    const int32_t* __restrict__ segs, int n_seg,
                    const uint8_t* __restrict__ ring_in,
                    int4* __restrict__ state, int* __restrict__ flags) {
  const int i = blockIdx.x;
  const size_t w = size_t(i) * WORDS + threadIdx.x;
  const int4 c = code[w];
  const int s = segment_of(segs, n_seg, i);
  int4 v = make_int4(-1, -1, -1, -1);   // outside every segment: 0
  if (s >= 0 && i < segs[3 * s + 1]) {
    const int lo = segs[3 * s];
    const uint8_t* init = segs[3 * s + 2] != 0 ? ring_in : nullptr;
    const int blk = (scal[i] & 255) >> 3;
    v = make_int4(source(c.x, i, lo, blk, init), source(c.y, i, lo, blk, init),
                  source(c.z, i, lo, blk, init), source(c.w, i, lo, blk, init));
  }
  state[w] = v;
  const bool left = v.x >= 0 || v.y >= 0 || v.z >= 0 || v.w >= 0;
  // one flag store a block, none once it is set: stores of one address
  // from every warp queue up in L2
  if (__syncthreads_or(left) && threadIdx.x == 0 &&
      *reinterpret_cast<volatile int*>(flags) == 0)
    flags[0] = 1;
}

// A pointer v becomes the word it points at, read from L2 (another SM may
// have written it in this pass; L1 could hold an older word).
__device__ __forceinline__ void jump(int& v, const int* st, bool& left) {
  if (v >= 0) {
    v = __ldcg(st + v);
    left |= v >= 0;
  }
}

// One pass of pointer jumping, in place, over the whole state: the grid
// (a few blocks an SM) strides through it in order, so a word often reads
// one that this pass has already moved on.
__global__ void __launch_bounds__(JUMP_THREADS)
mxu2_jump_kernel(int4* state, int* flags, int pass, size_t n_words) {
  if (flags[pass - 1] == 0) return;     // the last pass left nothing
  const int* st = reinterpret_cast<const int*>(state);
  bool left = false;
  for (size_t w = size_t(blockIdx.x) * JUMP_THREADS + threadIdx.x;
       w < n_words; w += size_t(gridDim.x) * JUMP_THREADS) {
    int4 v = __ldcg(state + w);
    if ((v.x & v.y & v.z & v.w) < 0) continue;   // all four resolved
    jump(v.x, st, left);
    jump(v.y, st, left);
    jump(v.z, st, left);
    jump(v.w, st, left);
    state[w] = v;
  }
  if (__syncthreads_or(left) && threadIdx.x == 0) flags[pass] = 1;
}

__device__ __forceinline__ uint32_t bytes4(int4 v) {
  return uint32_t(~v.x & 255) | uint32_t(~v.y & 255) << 8 |
         uint32_t(~v.z & 255) << 16 | uint32_t(~v.w & 255) << 24;
}

// rows from the resolved state (n_words int4 words), then ring_out: 4
// bytes a thread past them.
__global__ void __launch_bounds__(JUMP_THREADS)
mxu2_out_kernel(const int4* __restrict__ state,
                const int32_t* __restrict__ scal,
                const int32_t* __restrict__ segs, int n_seg,
                const uint8_t* __restrict__ ring_in, size_t n_words,
                uint32_t* __restrict__ out, uint32_t* __restrict__ ring_out) {
  const size_t w = size_t(blockIdx.x) * JUMP_THREADS + threadIdx.x;
  if (w < n_words) {
    out[w] = bytes4(state[w]);
    return;
  }
  const int r = int(w - n_words);       // ring word: bytes 4r .. 4r + 3
  if (r >= RING / 4) return;
  uint32_t val = 0;
  if (n_seg > 0) {
    const int lo = segs[3 * (n_seg - 1)];
    const int hi = segs[3 * (n_seg - 1) + 1];
    const bool carry = segs[3 * (n_seg - 1) + 2] != 0 && ring_in != nullptr;
    const int o = 4 * r;
    const int last = (scal[hi - 1] & 255) >> 3;
    const int k = hi - 1 - ((last - (o >> 11)) & (RING_BLOCKS - 1));
    if (k >= lo)
      val = bytes4(state[(size_t(k) * SUB + (o & (SUB - 1))) / 4]);
    else if (carry)
      val = reinterpret_cast<const uint32_t*>(ring_in)[r];
  }
  ring_out[r] = val;
}

}  // namespace

// scratch: n * SUB int32 state words, then passes + 1 int32 flags
LZ4T_API int lz4t_mxu2_route(const int32_t* code, const int32_t* scal,
                             const int32_t* segs, int n_seg,
                             const uint8_t* ring_in, uint8_t* out,
                             uint8_t* ring_out, int n, int passes,
                             void* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_words = size_t(n) * WORDS;
  int4* state = static_cast<int4*>(scratch);
  int* flags = reinterpret_cast<int*>(state + n_words);
  cudaError_t e = cudaMemsetAsync(flags, 0, sizeof(int) * (passes + 1), st);
  if (e != cudaSuccess) return int(e);
  if (n > 0) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return int(e);
    const size_t grid = std::min(n_words / JUMP_THREADS,
                                 size_t(sms) * JUMP_BLOCKS_PER_SM);
    mxu2_sources_kernel<<<n, ROUTE_THREADS, 0, st>>>(
        reinterpret_cast<const int4*>(code), scal, segs, n_seg, ring_in,
        state, flags);
    for (int p = 1; p <= passes; ++p)
      mxu2_jump_kernel<<<unsigned(grid), JUMP_THREADS, 0, st>>>(
          state, flags, p, n_words);
  }
  const size_t threads = n_words + RING / 4;
  mxu2_out_kernel<<<unsigned((threads + JUMP_THREADS - 1) / JUMP_THREADS),
                    JUMP_THREADS, 0, st>>>(
      state, scal, segs, n_seg, ring_in, n_words,
      reinterpret_cast<uint32_t*>(out), reinterpret_cast<uint32_t*>(ring_out));
  return int(cudaGetLastError());
}
