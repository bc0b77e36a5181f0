// H1: fused decode, as two kernels: a parallel expand and a serial route.
//
// Replaces lz4tpu/device/fused.py::_make_kernel (K1, pallas_call at
// :1468), whose spec is fused.golden_decode (:718).  The pair has the
// shape of the TPU's split variant (_make_expand_kernel and
// _make_route_kernel, :1156 and :1262).
//
// expand: one block per 2 KiB substep, all substeps in parallel.  It
//   decodes the substep's sequence records exactly as _decode_records
//   (:206), scatters the U/V/B deltas into three 2048-entry shared maps
//   with atomicAdd, takes a block-wide inclusive scan, adds the carry
//   scalars scal[i,3..5], forms each byte's 17-bit source (pos17: the
//   ring below 65536, the literal window above), and applies the
//   in-substep patch records.  Output: pos17 as int32, 4 B per byte.
//   Bound on an H100: shared-memory atomics and the scan, per substep;
//   device memory sees 6.5 KiB of records in and 8 KiB of pos17 out per
//   substep.  Design: the TPU needed one-hot matmuls over bf16 digit
//   planes to scatter; here atomics on shared memory scatter directly.
//
// route: one block per chain segment.  The block walks its substeps in
//   order, gathers 2048 bytes per substep from ring or literal window,
//   writes them out and into ring rows scal[i,0].  Bound on an H100: not
//   bytes (12 KiB in and 2 KiB out a substep would take nanoseconds) but
//   the serial substep loop of one chain on one SM: a substep reads what
//   the one before it wrote, so its time is two block barriers (0.14 us
//   for 16 warps), the copy of its 12 KiB into shared memory and the
//   byte gather.  Design: nothing is read from device memory inside the
//   loop.  cp.async keeps the next STAGES substeps' pos17 (8 KiB) and
//   literal window (4 KiB) in shared-memory stages beside the 64 KiB
//   ring; the scalars that give a window's address and a substep's ring
//   row are staged in shared memory SCAL_CHUNK substeps at a time, half
//   a chunk ahead, so no load waits on another.  The windows lie right
//   behind the ring, so a source is one shared-memory offset and the
//   ring-or-window choice a select.  Each thread gathers 4 bytes and
//   stores one 32-bit word.  Parallelism comes from independent chains
//   (one block each).
#include "common.cuh"

namespace {

using namespace lz4t;

constexpr int SEQ_MAX = 576;       // seq records per substep
constexpr int PATCH_MAX = 256;     // patch records per substep
constexpr int TAG = 1 << 17;       // patch marker above the 17-bit space
constexpr int U_BIAS = RING - SUB; // literal pos17 = j + U + U_BIAS
constexpr int EXPAND_THREADS = 256;
constexpr int PER_T = SUB / EXPAND_THREADS;  // 8 consecutive bytes a thread
constexpr int NWARP = EXPAND_THREADS / 32;
constexpr int STAGES = 4;           // substeps in flight in the route
constexpr int SCAL_CHUNK = 128;     // substeps of scalars staged at once
// route shared memory: ring | STAGES windows | STAGES pos17 | 2 chunks of
// scalars (window index, window row, ring row, -) as int4
constexpr int ROUTE_POS = RING + STAGES * WIN;
constexpr int ROUTE_SCAL = ROUTE_POS + STAGES * SUB * 4;
constexpr int ROUTE_SMEM = ROUTE_SCAL + 2 * SCAL_CHUNK * 16;

__device__ __forceinline__ int digit(uint32_t r, int shift) {
  return int((r >> shift) & 255u) - 128;
}

__global__ void __launch_bounds__(EXPAND_THREADS)
fused_expand_kernel(const uint32_t* __restrict__ seqrec,
                    const int32_t* __restrict__ scal,
                    const int32_t* __restrict__ patch,
                    int32_t* __restrict__ pos17) {
  __shared__ __align__(16) int mU[SUB];
  __shared__ __align__(16) int mV[SUB];
  __shared__ __align__(16) int mB[SUB];
  __shared__ int wsum[3][NWARP];
  const int i = blockIdx.x;
  const int t = threadIdx.x;

  for (int k = t; k < SUB; k += EXPAND_THREADS) {
    mU[k] = 0;
    mV[k] = 0;
    mB[k] = 0;
  }
  __syncthreads();

  // records: stream 0 then stream 1, SEQ_MAX slots each; empty slots
  // are 0 (a real record always has a nonzero biased carry digit)
  const uint32_t* r0p = seqrec + size_t(i) * 2 * SEQ_MAX;
  const uint32_t* r1p = r0p + SEQ_MAX;
  for (int k = t; k < SEQ_MAX; k += EXPAND_THREADS) {
    const uint32_t r0 = r0p[k];
    if (r0 == 0u) continue;
    const uint32_t r1 = r1p[k];
    const int p = int(r0 & 0xFFFu);
    if (p >= SUB) continue;
    atomicAdd(&mU[p], digit(r0, 12) + digit(r0, 20) * 256);
    atomicAdd(&mV[p], digit(r1, 0) + digit(r1, 8) * 256 +
                          (int((r0 >> 28) & 7u) - 4) * 65536);
    atomicAdd(&mB[p], digit(r1, 16) + digit(r1, 24) * 256);
  }
  __syncthreads();

  // block-wide inclusive scan: 8 consecutive entries per thread, then a
  // warp shuffle scan of the thread totals, then the warp totals
  const int j0 = t * PER_T;
  int u[PER_T], v[PER_T], b[PER_T];
  int su = 0, sv = 0, sb = 0;
#pragma unroll
  for (int q = 0; q < PER_T; ++q) {
    su += mU[j0 + q];
    sv += mV[j0 + q];
    sb += mB[j0 + q];
    u[q] = su;
    v[q] = sv;
    b[q] = sb;
  }
  const int lane = t & 31;
  const int w = t >> 5;
  int xu = su, xv = sv, xb = sb;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int yu = __shfl_up_sync(0xffffffffu, xu, off);
    const int yv = __shfl_up_sync(0xffffffffu, xv, off);
    const int yb = __shfl_up_sync(0xffffffffu, xb, off);
    if (lane >= off) {
      xu += yu;
      xv += yv;
      xb += yb;
    }
  }
  if (lane == 31) {
    wsum[0][w] = xu;
    wsum[1][w] = xv;
    wsum[2][w] = xb;
  }
  __syncthreads();
  int cu = scal[size_t(i) * 8 + 3] + xu - su;
  int cv = scal[size_t(i) * 8 + 4] + xv - sv;
  int cb = scal[size_t(i) * 8 + 5] + xb - sb;
  for (int k = 0; k < w; ++k) {
    cu += wsum[0][k];
    cv += wsum[1][k];
    cb += wsum[2][k];
  }
  int pv[PER_T];
#pragma unroll
  for (int q = 0; q < PER_T; ++q) {
    const int j = j0 + q;
    pv[q] = j < cb + b[q] ? j + cu + u[q] + U_BIAS : (j + cv + v[q]) & 0xFFFF;
  }
  __syncthreads();  // every map read is done: mU becomes the pos17 grid
#pragma unroll
  for (int q = 0; q < PER_T; ++q) mU[j0 + q] = pv[q];
  __syncthreads();

  // patches: rec = pos << 18 | code18; code18 >= TAG overrides the byte
  // at pos (positions are unique within a substep)
  for (int k = t; k < PATCH_MAX; k += EXPAND_THREADS) {
    const int r = patch[size_t(i) * PATCH_MAX + k];
    if (r == 0) continue;
    const int p = r >> 18;
    const int code = r & 0x3FFFF;
    if (code >= TAG && p >= 0 && p < SUB) mU[p] = code - TAG;
  }
  __syncthreads();

  int4* dst = reinterpret_cast<int4*>(pos17 + size_t(i) * SUB);
  const int4* src = reinterpret_cast<const int4*>(mU);
  for (int k = t; k < SUB / 4; k += EXPAND_THREADS) dst[k] = src[k];
}

// A pos17 source as a shared-memory offset: the ring below RING, the
// stage's window (at RING + woff) above.
__device__ __forceinline__ int unified(int p, int woff) {
  return p < RING ? max(p, 0) : min(p, RING + WIN - 1) + woff;
}

// segs[3*s..3*s+2] = (first substep, end substep, carry ring_in)
__global__ void __launch_bounds__(ROUTE_THREADS)
fused_route_kernel(const int4* __restrict__ pos17,
                   const uint8_t* __restrict__ lits,
                   const int32_t* __restrict__ winq,
                   const int32_t* __restrict__ scal,
                   const int32_t* __restrict__ segs,
                   const uint8_t* __restrict__ ring_in,
                   uint8_t* __restrict__ out, uint8_t* __restrict__ ring_out,
                   int n_seg) {
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  int4* s_scal = reinterpret_cast<int4*>(smem + ROUTE_SCAL);
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int lo = segs[3 * s];
  const int hi = segs[3 * s + 1];

  // scalars: chunk c (substeps lo + c*SCAL_CHUNK ...) goes through
  // registers into half c&1 of s_scal, fetched a chunk and a half ahead
  int4 chunk = make_int4(0, 0, 0, 0);
  auto fetch = [&](int c) {
    const int i = lo + c * SCAL_CHUNK + t;
    if (t < SCAL_CHUNK && i < hi)
      chunk = make_int4(winq[i], scal[size_t(i) * 8 + 1],
                        scal[size_t(i) * 8], 0);
  };
  auto put = [&](int c) {
    if (t < SCAL_CHUNK) s_scal[(c & 1) * SCAL_CHUNK + t] = chunk;
  };
  auto scalars = [&](int k) -> int4 {     // of substep lo + k
    return s_scal[((k / SCAL_CHUNK) & 1) * SCAL_CHUNK + k % SCAL_CHUNK];
  };
  // start substep i's copies into its stage; one group a substep, empty
  // beyond the segment so that the group count stays in step
  auto start_copies = [&](int i) {
    if (i < hi) {
      const int slot = (i - lo) % STAGES;
      const int4 sc = scalars(i - lo);
      cp_async16(smem + ROUTE_POS + slot * (SUB * 4) + t * 16,
                 pos17 + size_t(i) * (SUB / 4) + t);
      if (t < WIN / 16)
        cp_async16(smem + RING + slot * WIN + t * 16,
                   lits + size_t(sc.x) * WIN_STRIDE + size_t(sc.y) * ROWB +
                       t * 16);
    }
    cp_async_commit();
  };
  fetch(0);
  put(0);
  fetch(1);
  ring_init(smem4, ring_in, segs[3 * s + 2] != 0 && ring_in != nullptr);
  __syncthreads();
  for (int d = 0; d < STAGES - 1; ++d) start_copies(lo + d);

  for (int i = lo; i < hi; ++i) {
    const int k = i - lo;
    const int slot = k % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of substep i
    __syncthreads();  // everyone's; and last substep's ring rows written
    if (k % SCAL_CHUNK == SCAL_CHUNK / 2) {
      put(k / SCAL_CHUNK + 1);
      fetch(k / SCAL_CHUNK + 2);
    }
    start_copies(i + STAGES - 1);   // into the stage substep i-1 has left
    const int4 p =
        reinterpret_cast<const int4*>(smem + ROUTE_POS + slot * (SUB * 4))[t];
    const int woff = slot * WIN;
    const uint32_t val =
        gather4(smem, unified(p.x, woff), unified(p.y, woff),
                unified(p.z, woff), unified(p.w, woff));
    const int row = scalars(k).z & 255;
    __syncthreads();  // every gather of this substep read the old ring
    reinterpret_cast<uint32_t*>(smem + row * ROWB)[t] = val;
    reinterpret_cast<uint32_t*>(out + size_t(i) * SUB)[t] = val;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (s == n_seg - 1) ring_store(smem4, ring_out);
}

}  // namespace

LZ4T_API int lz4t_fused_expand(const int32_t* seqrec, const int32_t* scal,
                               const int32_t* patch, int32_t* pos17,
                               int64_t n_sub, void* stream) {
  if (n_sub > 0)
    fused_expand_kernel<<<unsigned(n_sub), EXPAND_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(seqrec), scal, patch, pos17);
  return int(cudaGetLastError());
}

LZ4T_API int lz4t_fused_route(const int32_t* pos17, const uint8_t* lits,
                              const int32_t* winq, const int32_t* scal,
                              const int32_t* segs, int n_seg,
                              const uint8_t* ring_in, uint8_t* out,
                              uint8_t* ring_out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ROUTE_SMEM);
  if (e != cudaSuccess) return int(e);
  if (n_seg > 0)
    fused_route_kernel<<<n_seg, ROUTE_THREADS, ROUTE_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const int4*>(pos17), lits, winq, scal, segs, ring_in,
        out, ring_out, n_seg);
  return int(cudaGetLastError());
}
