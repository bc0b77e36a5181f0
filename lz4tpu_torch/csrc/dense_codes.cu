// H9: dense_codes, the mxu2 engine's per-byte routing codes built on the card.
//
// Replaces no TPU kernel: it moves the host packer onto the card
// (lz4tpu/device/mxu2.py::_pack_chain, the numpy spec; the native
// pack_dense2_range in native/lz4core.cpp, serial; in the port
// device/mxu2.py::dense_codes_plain).  It writes exactly the int32 codes the
// host packer writes, in the (n_sub, 2048) layout that H3 (mxu2.cu) reads:
// bit 16 set -> the ring byte at code & 0xFFFF; bit 16 clear -> the known
// byte (code >> 17) & 255; 0 past a chain's end.
//
// Inputs: the dense chains' sequence columns staged once a request, int32
// rows out_start (global output offset), lit_len, lit_src (offset into the
// compressed buffer), match_len, match_off, each n_seq long; a table of the
// chains that have bytes, one row of five int32 each (first substep of the
// pack, first and end sequence in the staged columns, out_start of the
// chain's first sequence, bytes out); the compressed buffer on the card.
//
// Bound on an H100: bytes, the columns read once (20 B a sequence) and the
// codes written once (4 B a byte).  The host packer walked every byte of a
// request on one thread.  Design: one block a substep of 2048 bytes, four
// bytes a thread.
//   locate: warp 0 finds the block's chain and its first sequence by 32-way
//     searches (a ballot of 32 probes a round: 5 rounds over 13 M
//     sequences), not by one thread's binary search.
//   fill: the substep's sequences come into shared memory in chunks of 512,
//     coalesced; each byte finds its sequence by a binary search there and
//     becomes a literal (its value from the compressed buffer), a ring code
//     (its source lies before the substep) or a pointer to an earlier byte
//     of the same substep.
//   resolve: pointer doubling in shared memory, P[b] = P[P[b]], at most 11
//     rounds (a chain inside a substep has fewer than 2048 links), ending
//     early in the round that changes nothing.
//   store: one int4 a thread, neighbouring threads on neighbouring words.
// A match that reaches before its chain's start is the host packer's status
// 2: the kernel stores 2 in *flag, and the wrapper raises after reading it.
#include "common.cuh"

namespace {

using namespace lz4t;

constexpr int THREADS = ROUTE_THREADS;   // 512: 4 bytes a thread
constexpr int CHUNK = THREADS;           // sequences in shared memory at once
constexpr int KIND_RING = 1 << 16;
constexpr int CHAIN_ROW = 5;             // sub_lo, seq_lo, seq_hi, out_lo, n_out
constexpr int STATUS_BEFORE_CHAIN = 2;   // the host packer's status

// The last index p in [lo, hi) with le(p) true, where le holds for a prefix
// of the range and for lo; called by all 32 lanes of one warp.
template <class Le>
__device__ __forceinline__ int warp_last_le(int lo, int hi, Le le) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, p < hi && le(p));
    lo += (31 - __clz(m)) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
dense_codes_kernel(const int32_t* __restrict__ cols, long long n_seq,
                   const int32_t* __restrict__ chains, int n_chains,
                   const uint8_t* __restrict__ comp, int p0,
                   int4* __restrict__ code, int* __restrict__ flag) {
  __shared__ int s_start[CHUNK];   // sequence start - substep start
  __shared__ int s_ll[CHUNK], s_ls[CHUNK], s_ml[CHUNK], s_mo[CHUNK];
  __shared__ int s_code[SUB];
  __shared__ short s_ptr[SUB];
  __shared__ int s_chain, s_seq0;

  const int32_t* out_start = cols;
  const int32_t* lit_len = cols + n_seq;
  const int32_t* lit_src = cols + 2 * n_seq;
  const int32_t* match_len = cols + 3 * n_seq;
  const int32_t* match_off = cols + 4 * n_seq;
  const int g = p0 + int(blockIdx.x);     // substep of the pack

  if (threadIdx.x < 32) {
    const int c = warp_last_le(0, n_chains, [&](int p) {
      return chains[CHAIN_ROW * p] <= g;
    });
    const int32_t* row = chains + CHAIN_ROW * c;
    const long long j0 = (long long)(g - row[0]) * SUB;
    const int out_lo = row[3];
    const int s0 = warp_last_le(row[1], row[2], [&](int p) {
      return (long long)(out_start[p] - out_lo) <= j0;
    });
    if (threadIdx.x == 0) {
      s_chain = c;
      s_seq0 = s0;
    }
  }
  __syncthreads();
  const int32_t* row = chains + CHAIN_ROW * s_chain;
  const long long j0 = (long long)(g - row[0]) * SUB;   // chain-relative
  const int seq_hi = row[2];
  const int out_lo = row[3];
  const long long left = (long long)row[4] - j0;
  const int valid = left < SUB ? int(left) : SUB;

  // each byte: a known code and itself, or a pointer to an earlier byte
  int h[4], c[4];
  bool todo[4];
  for (int k = 0; k < 4; ++k) {
    const int b = 4 * int(threadIdx.x) + k;
    h[k] = b;
    c[k] = 0;
    todo[k] = b < valid;
  }
  bool fault = false;
  for (int base = s_seq0;;) {
    const int s = base + int(threadIdx.x);
    const bool in = s < seq_hi && (out_start[s] - out_lo) < j0 + valid;
    if (in) {
      s_start[threadIdx.x] = int((long long)(out_start[s] - out_lo) - j0);
      s_ll[threadIdx.x] = lit_len[s];
      s_ls[threadIdx.x] = lit_src[s];
      s_ml[threadIdx.x] = match_len[s];
      s_mo[threadIdx.x] = match_off[s];
    }
    const int count = __syncthreads_count(in);
    for (int k = 0; k < 4 && count > 0; ++k) {
      const int b = 4 * int(threadIdx.x) + k;
      if (!todo[k] || s_start[0] > b) continue;
      int lo = 0, hi = count;           // the last sequence starting <= b
      while (hi - lo > 1) {
        const int m = (lo + hi) >> 1;
        if (s_start[m] <= b) lo = m;
        else hi = m;
      }
      const long long local = (long long)b - s_start[lo];
      if (local >= (long long)s_ll[lo] + s_ml[lo]) continue;  // a later one
      todo[k] = false;
      if (local < s_ll[lo]) {
        c[k] = int(comp[(long long)s_ls[lo] + local]) << 17;
        continue;
      }
      const int off = s_mo[lo] >= 1 ? s_mo[lo] : 1;
      const long long src = j0 + b - off;
      if (src < 0) fault = true;
      else if (src < j0) c[k] = int(src & 0xFFFF) | KIND_RING;
      else h[k] = b - off;
    }
    const bool more = todo[0] || todo[1] || todo[2] || todo[3];
    // count 0 with bytes left: columns that do not tile the chain; stop
    if (!__syncthreads_or(more) || count == 0) break;
    base += count;
  }
  if (fault) *flag = STATUS_BEFORE_CHAIN;

  for (int k = 0; k < 4; ++k) {
    s_code[4 * threadIdx.x + k] = c[k];
    s_ptr[4 * threadIdx.x + k] = short(h[k]);
  }
  __syncthreads();
  for (int round = 0; round < 11; ++round) {
    int nh[4];
    bool changed = false;
    for (int k = 0; k < 4; ++k) {
      nh[k] = s_ptr[h[k]];
      changed |= nh[k] != h[k];
    }
    if (!__syncthreads_or(changed)) break;
    for (int k = 0; k < 4; ++k) {
      h[k] = nh[k];
      s_ptr[4 * threadIdx.x + k] = short(nh[k]);
    }
    __syncthreads();
  }
  code[size_t(blockIdx.x) * (SUB / 4) + threadIdx.x] =
      make_int4(s_code[h[0]], s_code[h[1]], s_code[h[2]], s_code[h[3]]);
}

}  // namespace

// cols: 5 rows of n_seq int32; chains: n_chains rows of 5 int32, in substep
// order; code: n substeps of the pack from substep p0; flag: one int32, 0 on
// entry, 2 after a match that reaches before its chain's start.
LZ4T_API int lz4t_dense_codes(const int32_t* cols, long long n_seq,
                              const int32_t* chains, int n_chains,
                              const uint8_t* comp, int p0, int n,
                              int32_t* code, int* flag, void* stream) {
  if (n > 0)
    dense_codes_kernel<<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        cols, n_seq, chains, n_chains, comp, p0, reinterpret_cast<int4*>(code),
        flag);
  return int(cudaGetLastError());
}
