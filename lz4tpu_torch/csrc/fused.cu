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
//   Bound on an H100: bytes, 4.5 KiB of records, 1 KiB of patches and 32
//   B of scalars in and 8 KiB of pos17 out a substep; a launch of a few
//   hundred substeps is one wave, and one block's path is its time.
//   Design: every device-memory load (two 16-byte vectors of records or
//   one of patches a thread, and the carries) is issued before the maps
//   are cleared, so no load waits behind another or behind a barrier.
//   Lane l of warp w scans bytes 256w + 4l and 256w + 128 + 4l (four
//   each): its map reads are conflict-free 16-byte loads, and each of
//   the warp's two pos17 stores, straight from registers, is 512
//   contiguous bytes.  Patches are stored over the block's own pos17
//   after one more barrier (four in all).  32 registers and 24 KiB of
//   shared memory: 8 blocks an SM.  The TPU needed one-hot matmuls over
//   bf16 digit planes to scatter; here atomics on shared memory do.
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
constexpr int NWARP = EXPAND_THREADS / 32;
constexpr int REC4 = SEQ_MAX / 4;   // 16-byte vectors of one record stream
constexpr int PATCH4 = PATCH_MAX / 4;  // of one substep's patch records
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

__device__ __forceinline__ void scatter(int* maps, uint32_t r0, uint32_t r1) {
  const int p = int(r0 & 0xFFFu);
  if (r0 == 0u || p >= SUB) return;
  atomicAdd(&maps[p], digit(r0, 12) + digit(r0, 20) * 256);
  atomicAdd(&maps[SUB + p], digit(r1, 0) + digit(r1, 8) * 256 +
                                (int((r0 >> 28) & 7u) - 4) * 65536);
  atomicAdd(&maps[2 * SUB + p], digit(r1, 16) + digit(r1, 24) * 256);
}

// Inclusive warp scan of three values.
__device__ __forceinline__ void warp_scan3(int& x, int& y, int& z, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, x, off);
    const int b = __shfl_up_sync(0xffffffffu, y, off);
    const int c = __shfl_up_sync(0xffffffffu, z, off);
    if (lane >= off) {
      x += a;
      y += b;
      z += c;
    }
  }
}

__device__ __forceinline__ int sum4(int4 a) { return a.x + a.y + a.z + a.w; }

// pos17 of byte j from the inclusive sums u, v, b at j (carries included)
__device__ __forceinline__ int pos_of(int j, int u, int v, int b) {
  return j < b ? j + u + U_BIAS : (j + v) & 0xFFFF;
}

// Four bytes j0 .. j0+3 from the map values mu, mv, mb and the running
// sums before them (advanced past them on return).
__device__ __forceinline__ int4 pos4(int j0, int4 mu, int4 mv, int4 mb,
                                     int& u, int& v, int& b) {
  int4 p;
  u += mu.x; v += mv.x; b += mb.x; p.x = pos_of(j0, u, v, b);
  u += mu.y; v += mv.y; b += mb.y; p.y = pos_of(j0 + 1, u, v, b);
  u += mu.z; v += mv.z; b += mb.z; p.z = pos_of(j0 + 2, u, v, b);
  u += mu.w; v += mv.w; b += mb.w; p.w = pos_of(j0 + 3, u, v, b);
  return p;
}

__device__ __forceinline__ void put_patch(int32_t* dst, int r) {
  const int p = r >> 18;
  const int code = r & 0x3FFFF;
  if (r != 0 && code >= TAG && p >= 0 && p < SUB) dst[p] = code - TAG;
}

__global__ void __launch_bounds__(EXPAND_THREADS, 8)
fused_expand_kernel(const int4* __restrict__ seqrec,
                    const int32_t* __restrict__ scal,
                    const int4* __restrict__ patch,
                    int32_t* __restrict__ pos17) {
  __shared__ __align__(16) int maps[3 * SUB];  // U, V, B deltas
  __shared__ int wsum[3][NWARP];
  const int i = blockIdx.x;
  const int t = threadIdx.x;

  // every device-memory load first: a thread below REC4 takes 4 records
  // of each stream (empty slots are 0: a real record always has a nonzero
  // biased carry digit), the next PATCH4 threads 4 patch records each
  int4 a = make_int4(0, 0, 0, 0), b = a;
  if (t < REC4) {
    a = seqrec[size_t(i) * 2 * REC4 + t];
    b = seqrec[size_t(i) * 2 * REC4 + REC4 + t];
  } else if (t < REC4 + PATCH4) {
    a = patch[size_t(i) * PATCH4 + t - REC4];
  }
  const int u0 = scal[size_t(i) * 8 + 3];
  const int v0 = scal[size_t(i) * 8 + 4];
  const int b0 = scal[size_t(i) * 8 + 5];
  int4* maps4 = reinterpret_cast<int4*>(maps);
  for (int k = t; k < 3 * SUB / 4; k += EXPAND_THREADS)
    maps4[k] = make_int4(0, 0, 0, 0);
  __syncthreads();
  if (t < REC4) {
    scatter(maps, a.x, b.x);
    scatter(maps, a.y, b.y);
    scatter(maps, a.z, b.z);
    scatter(maps, a.w, b.w);
  }
  __syncthreads();

  // block-wide inclusive scan of the three maps.  Lane l of warp w holds
  // bytes 256w + 4l .. +3 (map chunk ca) and 256w + 128 + 4l .. +3
  // (chunk cb): each of its warp's two 16-byte pos17 stores then covers
  // 512 contiguous bytes, and the map reads hit every bank once.  Two
  // warp scans (chunks A, then chunks B after the warp's last A), then
  // the warp totals.
  const int lane = t & 31;
  const int w = t >> 5;
  const int ca = 64 * w + lane;
  const int cb = ca + 32;
  const int su = sum4(maps4[ca]), sv = sum4(maps4[SUB / 4 + ca]),
            sb = sum4(maps4[SUB / 2 + ca]);
  int xu = su, xv = sv, xb = sb;
  warp_scan3(xu, xv, xb, lane);
  const int tu = sum4(maps4[cb]), tv = sum4(maps4[SUB / 4 + cb]),
            tb = sum4(maps4[SUB / 2 + cb]);
  int yu = tu, yv = tv, yb = tb;
  warp_scan3(yu, yv, yb, lane);
  const int au = __shfl_sync(0xffffffffu, xu, 31);
  const int av = __shfl_sync(0xffffffffu, xv, 31);
  const int ab = __shfl_sync(0xffffffffu, xb, 31);
  if (lane == 31) {
    wsum[0][w] = au + yu;
    wsum[1][w] = av + yv;
    wsum[2][w] = ab + yb;
  }
  __syncthreads();
  int bu = u0, bv = v0, bb = b0;
#pragma unroll
  for (int k = 0; k < NWARP - 1; ++k) {
    if (k < w) {
      bu += wsum[0][k];
      bv += wsum[1][k];
      bb += wsum[2][k];
    }
  }
  int4* dst = reinterpret_cast<int4*>(pos17 + size_t(i) * SUB);
  int cu = bu + xu - su, cv = bv + xv - sv, cl = bb + xb - sb;
  dst[ca] = pos4(4 * ca, maps4[ca], maps4[SUB / 4 + ca], maps4[SUB / 2 + ca],
                 cu, cv, cl);
  cu = bu + au + yu - tu;
  cv = bv + av + yv - tv;
  cl = bb + ab + yb - tb;
  dst[cb] = pos4(4 * cb, maps4[cb], maps4[SUB / 4 + cb], maps4[SUB / 2 + cb],
                 cu, cv, cl);

  // patches: rec = pos << 18 | code18; code18 >= TAG overrides the byte
  // at pos (positions are unique within a substep), stored over the
  // block's own pos17 once every thread has stored it
  __syncthreads();
  if (t >= REC4 && t < REC4 + PATCH4) {
    int32_t* row = pos17 + size_t(i) * SUB;
    put_patch(row, a.x);
    put_patch(row, a.y);
    put_patch(row, a.z);
    put_patch(row, a.w);
  }
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
        reinterpret_cast<const int4*>(seqrec), scal,
        reinterpret_cast<const int4*>(patch), pos17);
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
