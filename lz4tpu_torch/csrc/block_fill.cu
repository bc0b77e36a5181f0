// H2: block fill.
//
// Replaces lz4tpu/device/sparse_decode.py::_block_fill (its Pallas body
// `kern`, pallas_call at :246): fill n 512 KiB blocks, each with its own
// byte (the low 8 bits of vals[b]), for zeros/RLE chains.
//
// Bound on an H100: device-memory write bandwidth (one byte written per
// output byte, nothing read but one int32 per block).  Design: a
// grid-stride loop in which each thread stores 16-byte vectors, with
// neighbouring threads on neighbouring addresses, so every warp writes
// 512 contiguous bytes per instruction.  On the main path's shape (z9m,
// 18 blocks, 9.4 MB) the time is a launch's floor (an empty launch timed
// the same way takes 5 us) plus the bytes.  One wave of persistent
// blocks, each on a contiguous range with the fill byte in a register
// and 8 unrolled streaming stores a thread, tied this kernel on 18
// blocks and was 5% slower on 256; a TMA bulk-store version and three
// other store layouts were no faster (PERF.md).
#include "common.cuh"

namespace {

constexpr int FILL_BLK = 1 << 19;            // bytes per fill block
constexpr int VEC_PER_BLK = FILL_BLK / 16;   // 32768 = 1 << 15
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
block_fill_kernel(const int32_t* __restrict__ vals, uint4* __restrict__ out,
                  int64_t n_vec) {
  const int64_t step = int64_t(gridDim.x) * THREADS;
  for (int64_t k = int64_t(blockIdx.x) * THREADS + threadIdx.x; k < n_vec;
       k += step) {
    const uint32_t w = (uint32_t(vals[k >> 15]) & 255u) * 0x01010101u;
    out[k] = make_uint4(w, w, w, w);
  }
}

}  // namespace

LZ4T_API const char* lz4t_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

LZ4T_API int lz4t_block_fill(const int32_t* vals, int64_t n_blocks,
                             uint8_t* out, void* stream) {
  const int64_t n_vec = n_blocks * VEC_PER_BLK;
  if (n_vec > 0) {
    const int64_t want = (n_vec + THREADS - 1) / THREADS;
    const int grid = int(want < 132 * 32 ? want : 132 * 32);
    block_fill_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        vals, reinterpret_cast<uint4*>(out), n_vec);
  }
  return int(cudaGetLastError());
}
