// H6: segment-copy chain decode.
//
// Replaces lz4tpu/device/pallas_decode.py::_decode_kernel (pallas_call at
// :206): walk a chain's sequences in order; per sequence one literal copy
// from the compressed bytes and one match copy from the chain's own
// output, an overlapping match (offset < length) repeating its first
// `offset` bytes, which is what the TPU kernel's span-doubling replay
// produces.
//
// The TPU kernel's int32 word rows, +512 B coordinate shift, slack rows
// and realigning blends are Mosaic's layout and are not carried: bytes
// stay bytes in device memory.
//
// Bound on an H100: bytes (each compressed literal byte read once, each
// output byte written once); in practice the serial chain of matches
// bounds it: a match may read what an earlier one wrote, and then the block
// has to meet at a barrier first.  Design: one chain per thread block.
// Sequences are staged through shared memory in chunks of CHUNK.  Literal
// copies never depend on a match, so a chunk's literals are all copied
// first with no barrier between them (short runs one thread each, long
// runs over the whole block); then its matches run in order, each spread
// over the block's threads, with a barrier only where a match reads bytes
// written since the last one.  A match's source lies wholly before its
// destination start (the modulo folds an overlapping match onto its first
// `offset` bytes), so its bytes copy in parallel.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 256;        // sequences staged per step
constexpr int SHORT_LIT = 64;     // literal runs up to this: one thread

__global__ void __launch_bounds__(THREADS)
segment_decode_kernel(const uint8_t* __restrict__ comp,
                      const int32_t* __restrict__ seqs, int64_t n_seqs,
                      const int32_t* __restrict__ chains, uint8_t* out) {
  __shared__ int32_t s_dst[CHUNK], s_src[CHUNK], s_ll[CHUNK], s_off[CHUNK],
      s_ml[CHUNK];
  const int32_t* row = chains + 4 * blockIdx.x;
  const int seq_lo = row[0], seq_hi = row[1];
  const uint8_t* cbase = comp + row[2];
  uint8_t* obase = out + row[3];
  const int tid = threadIdx.x;

  for (int c0 = seq_lo; c0 < seq_hi; c0 += CHUNK) {
    const int n = min(CHUNK, seq_hi - c0);
    __syncthreads();              // the previous chunk's table is done with
    if (tid < n) {
      const int64_t i = c0 + tid;
      s_dst[tid] = seqs[i];
      s_src[tid] = seqs[n_seqs + i];
      s_ll[tid] = seqs[2 * n_seqs + i];
      s_off[tid] = max(seqs[3 * n_seqs + i], 1);   // 0 on a block's last
      s_ml[tid] = seqs[4 * n_seqs + i];
    }
    __syncthreads();

    // literals: short runs one thread each, long runs over the block
    if (tid < n && s_ll[tid] <= SHORT_LIT) {
      const uint8_t* s = cbase + s_src[tid];
      uint8_t* d = obase + s_dst[tid];
      for (int k = 0; k < s_ll[tid]; ++k) d[k] = s[k];
    }
    for (int j = 0; j < n; ++j) {
      const int ll = s_ll[j];
      if (ll > SHORT_LIT) {
        const uint8_t* s = cbase + s_src[j];
        uint8_t* d = obase + s_dst[j];
        for (int k = tid; k < ll; k += THREADS) d[k] = s[k];
      }
    }
    __syncthreads();

    // matches, in order; a barrier only before a match whose source
    // reaches into what matches wrote since the last barrier (everything
    // older is visible already).  Byte k of match j goes to thread
    // (k + 16 j) mod THREADS, so that short independent matches land on
    // different threads and their loads are in flight together.
    int dirty_lo = INT_MAX;       // lowest byte written since the barrier
    for (int j = 0; j < n; ++j) {
      const int ml = s_ml[j];
      if (ml == 0) continue;
      const int off = s_off[j];
      const int md = s_dst[j] + s_ll[j];
      if (md - off + min(ml, off) > dirty_lo) {
        __syncthreads();
        dirty_lo = INT_MAX;
      }
      dirty_lo = min(dirty_lo, md);
      uint8_t* d = obase + md;
      const uint8_t* s = d - off;
      const int k0 = (tid - 16 * j) & (THREADS - 1);
      if (off >= ml) {
        for (int k = k0; k < ml; k += THREADS) d[k] = s[k];
      } else {
        for (int k = k0; k < ml; k += THREADS) d[k] = s[k % off];
      }
    }
  }
}

}  // namespace

LZ4T_API int lz4t_segment_decode(const uint8_t* comp, const int32_t* seqs,
                                 int64_t n_seqs, const int32_t* chains,
                                 int n_chains, uint8_t* out, void* stream) {
  if (n_chains > 0)
    segment_decode_kernel<<<n_chains, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        comp, seqs, n_seqs, chains, out);
  return int(cudaGetLastError());
}
