// H8: emit_levels, the eight prefix levels of the device-emit encoder.
//
// Replaces the segmented scans inside lz4tpu/device/encode.py::
// _emit_inputs_device (:367; XLA there, no Pallas: the boundary counts,
// segmented minima and neighbour tests at :430-472) and, in the port,
// device/encode.py::_level_deltas, which stays as the plain version for
// CPU tensors.  Inputs: the padded buffer (n bytes, n a multiple of 1024)
// and the positions p[0..n) in the order of the encoder's one sort by the
// 32-byte prefix.  lcp(i), 0..8, is the number of leading 4-byte words of
// the 32 bytes at p[i] (read circularly over the buffer) that entry i
// shares with entry i - 1; lcp(0) = 0.  Level k = 4, 8, ..., 32 has its
// groups start where lcp(i) < k / 4.  Its candidates are the group's
// least position (levels 4, 8, 16 and 32 only) and the neighbours i +-
// {1, 2, 4, 8, 16} with no group start between (the least lcp over the
// window is at least k / 4).  The largest candidate c < p[i] with p[i] -
// c <= 65535 wins: out[k / 4 - 1][i] = p[i] - c, or 0 where none does.
//
// Bound on an H100: bytes.  Device memory sees 4 B of position in and 32
// B of distances out an entry; the 32 prefix bytes an entry reads at p[i]
// come from a buffer of a few MiB that stays in L2.  The plain version
// issues some 3,800 small operations a block (log-step scans of shifts,
// cats and masks), and the host's issue of them paced the encoder.  A
// group can span the whole buffer (zeros, or a frequent 4-gram), so the
// group minima need carries between tiles.  Design: three kernels on the
// caller's stream, over tiles of 2048 entries, one block of 256 threads a
// tile, 8 consecutive entries a thread.
//   tiles: lcp of every entry (the 32 bytes at p[i] and p[i - 1] as nine
//     aligned words each, shifted into place), into scratch; and for each
//     main level the tile's forward and backward function (below).
//   carry: one block; one warp per main level and direction scans the
//     tiles' functions into each tile's carry from the left and from the
//     right.
//   apply: per tile, the segmented prefix and suffix minima from those
//     carries (a block scan of the threads' functions), the neighbour
//     windows from lcp with a halo of 16 entries at each side, and all
//     eight levels, written as 16-byte vectors.
// A segmented minimum is a scan of functions x -> r ? a : min(a, x): an
// entry that starts its group (forward) or ends it (backward) resets the
// carry to its position, any other takes the least of the two.  Two such
// functions compose into one of the same form, so the scan is associative
// and runs in any grouping: entries, threads, warps, tiles.
// Scratch, from the wrapper: n bytes of lcp and 24 int32 a tile.
#include "common.cuh"

namespace {

constexpr int TILE = 2048;                 // entries a tile (a block)
constexpr int THREADS = 256;
constexpr int PER = TILE / THREADS;        // consecutive entries a thread
constexpr int WARPS = THREADS / 32;
constexpr int HALO = 16;                   // the farthest neighbour
constexpr int MAIN = 4;                    // levels 4, 8, 16, 32
constexpr int BIG = 0x7fffffff;
constexpr int WINDOW = 65535;              // the farthest a match reaches
constexpr unsigned FULL = 0xffffffffu;

// x -> r ? a : min(a, x): the carry of a segmented minimum after one or
// more entries.
struct Fn {
  int a;
  int r;
};

__device__ __forceinline__ Fn then(Fn f, Fn g) {        // g after f
  return Fn{g.r ? g.a : min(f.a, g.a), f.r | g.r};
}

__device__ __forceinline__ int apply(Fn f, int x) {
  return f.r ? f.a : min(f.a, x);
}

// lcp thresholds of the main levels: k / 4 for k = 4, 8, 16, 32
__device__ __forceinline__ int main_th(int m) { return 1 << m; }

// Layout of the tiles' scratch: [dir][a, r][level][tile], then the
// carries [dir][level][tile]; dir 0 is forward (from the left).
__device__ __forceinline__ int fn_at(int dir, int part, int m, int nt) {
  return ((dir * 2 + part) * MAIN + m) * nt;
}

__device__ __forceinline__ int carry_at(int dir, int m, int nt) {
  return 4 * MAIN * nt + (dir * MAIN + m) * nt;
}

// Inclusive scan of the lanes' functions, lower lanes applied first (REV:
// higher lanes first).  Returns the composition of the lanes before this
// one in that order (the identity for the first) and leaves the whole
// warp's in *total.
template <bool REV>
__device__ __forceinline__ Fn warp_exclusive(Fn f, int lane, Fn* total) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int pa = REV ? __shfl_down_sync(FULL, f.a, off)
                       : __shfl_up_sync(FULL, f.a, off);
    const int pr = REV ? __shfl_down_sync(FULL, f.r, off)
                       : __shfl_up_sync(FULL, f.r, off);
    if (REV ? lane + off < 32 : lane >= off) f = then(Fn{pa, pr}, f);
  }
  const int last = REV ? 0 : 31;
  *total = Fn{__shfl_sync(FULL, f.a, last), __shfl_sync(FULL, f.r, last)};
  Fn prev{REV ? __shfl_down_sync(FULL, f.a, 1) : __shfl_up_sync(FULL, f.a, 1),
          REV ? __shfl_down_sync(FULL, f.r, 1) : __shfl_up_sync(FULL, f.r, 1)};
  if (lane == (REV ? 31 : 0)) prev = Fn{BIG, 0};
  return prev;
}

// Each thread's forward (fw) and backward (bw) functions of the main
// levels become the composition of the threads before it in its warp;
// the warps' totals go to tot[dir][level][warp].
__device__ __forceinline__ void block_scan(Fn (&fw)[MAIN], Fn (&bw)[MAIN],
                                           Fn (*tot)[MAIN][WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MAIN; ++m) {
    Fn t;
    fw[m] = warp_exclusive<false>(fw[m], lane, &t);
    if (lane == 0) tot[0][m][warp] = t;
    bw[m] = warp_exclusive<true>(bw[m], lane, &t);
    if (lane == 0) tot[1][m][warp] = t;
  }
  __syncthreads();
}

// The thread's functions over its entries: forward, an entry resets where
// it starts its group (lcp[j] < th); backward, where it ends it (the next
// entry starts one: lcp[j + 1] < th).  `l` points at the thread's first
// entry's lcp in shared memory, `pv` holds its positions.
__device__ __forceinline__ void thread_fns(const uint8_t* l, const int* pv,
                                           Fn (&fw)[MAIN], Fn (&bw)[MAIN]) {
#pragma unroll
  for (int m = 0; m < MAIN; ++m) {
    const int th = main_th(m);
    Fn f{BIG, 0}, b{BIG, 0};
#pragma unroll
    for (int e = 0; e < PER; ++e) f = then(f, Fn{pv[e], l[e] < th});
#pragma unroll
    for (int e = PER - 1; e >= 0; --e) b = then(b, Fn{pv[e], l[e + 1] < th});
    fw[m] = f;
    bw[m] = b;
  }
}

// The 32 bytes at byte p of the buffer (nw words, read circularly) as
// eight little-endian words: nine aligned loads, shifted into place.
__device__ __forceinline__ void prefix32(const uint32_t* __restrict__ buf,
                                         uint32_t nw, int p,
                                         uint32_t (&w)[8]) {
  const uint32_t q = uint32_t(p) >> 2, sh = (uint32_t(p) & 3u) * 8u;
  uint32_t a[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    uint32_t j = q + k;
    if (j >= nw) j -= nw;
    a[k] = __ldg(buf + j);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = __funnelshift_r(a[k], a[k + 1], sh);
}

__device__ __forceinline__ int lcp8(const uint32_t (&a)[8],
                                    const uint32_t (&b)[8]) {
  int l = 8;
#pragma unroll
  for (int k = 7; k >= 0; --k)
    if (a[k] != b[k]) l = k;
  return l;
}

__device__ __forceinline__ void load8(const int32_t* __restrict__ p, int i0,
                                      int (&pv)[PER]) {
  const int4* v = reinterpret_cast<const int4*>(p + i0);
  const int4 x = v[0], y = v[1];
  pv[0] = x.x; pv[1] = x.y; pv[2] = x.z; pv[3] = x.w;
  pv[4] = y.x; pv[5] = y.y; pv[6] = y.z; pv[7] = y.w;
}

__global__ void __launch_bounds__(THREADS)
levels_tiles_kernel(const uint32_t* __restrict__ buf,
                    const int32_t* __restrict__ p, int n,
                    uint8_t* __restrict__ lcp, int32_t* __restrict__ tiles) {
  __shared__ __align__(16) uint8_t sl[TILE + 8];
  __shared__ Fn tot[2][MAIN][WARPS];
  const int nt = gridDim.x;
  const int tile0 = blockIdx.x * TILE;
  const int j0 = threadIdx.x * PER;
  const int i0 = tile0 + j0;
  const uint32_t nw = uint32_t(n) >> 2;
  int pv[PER];
  if (i0 < n) {           // n is a multiple of 1024: all 8 in range or none
    load8(p, i0, pv);
    uint32_t prev[8] = {}, cur[8];
    if (i0 > 0) prefix32(buf, nw, p[i0 - 1], prev);
    uint8_t l[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      prefix32(buf, nw, pv[e], cur);
      l[e] = (i0 + e == 0) ? 0 : uint8_t(lcp8(cur, prev));
#pragma unroll
      for (int k = 0; k < 8; ++k) prev[k] = cur[k];
    }
    uint2 packed;
    packed.x = l[0] | l[1] << 8 | l[2] << 16 | uint32_t(l[3]) << 24;
    packed.y = l[4] | l[5] << 8 | l[6] << 16 | uint32_t(l[7]) << 24;
    *reinterpret_cast<uint2*>(lcp + i0) = packed;
    *reinterpret_cast<uint2*>(sl + j0) = packed;
    if (threadIdx.x == THREADS - 1) {     // the next tile's first entry
      uint8_t next = 0;
      if (tile0 + TILE < n) {
        prefix32(buf, nw, p[tile0 + TILE], cur);
        next = uint8_t(lcp8(cur, prev));
      }
      sl[TILE] = next;
    }
  } else {                 // past the end: each its own group, never seen
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      pv[e] = BIG;
      sl[j0 + e] = 0;
    }
    if (threadIdx.x == THREADS - 1) sl[TILE] = 0;
  }
  __syncthreads();
  Fn fw[MAIN], bw[MAIN];
  thread_fns(sl + j0, pv, fw, bw);
  block_scan(fw, bw, tot);
  if (threadIdx.x < MAIN) {
    const int m = threadIdx.x;
    Fn f{BIG, 0}, b{BIG, 0};
    for (int w = 0; w < WARPS; ++w) f = then(f, tot[0][m][w]);
    for (int w = WARPS - 1; w >= 0; --w) b = then(b, tot[1][m][w]);
    tiles[fn_at(0, 0, m, nt) + blockIdx.x] = f.a;
    tiles[fn_at(0, 1, m, nt) + blockIdx.x] = f.r;
    tiles[fn_at(1, 0, m, nt) + blockIdx.x] = b.a;
    tiles[fn_at(1, 1, m, nt) + blockIdx.x] = b.r;
  }
}

// One block: warp w scans main level w % 4, forward (w < 4) or backward,
// over the tiles; each lane takes a contiguous run of them in the scan's
// order.  A tile's carry is the composition of the tiles before it in
// that order applied to BIG (nothing before the buffer's first entry or
// after its last).
__global__ void __launch_bounds__(THREADS)
levels_carry_kernel(int32_t* __restrict__ tiles, int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp % MAIN, dir = warp / MAIN;
  const int32_t* fa = tiles + fn_at(dir, 0, m, nt);
  const int32_t* fr = tiles + fn_at(dir, 1, m, nt);
  int32_t* carry = tiles + carry_at(dir, m, nt);
  const int run = (nt + 31) / 32;
  const int lo = min(nt, lane * run), hi = min(nt, lo + run);
  Fn f{BIG, 0};
  for (int v = lo; v < hi; ++v) {
    const int b = dir ? nt - 1 - v : v;
    f = then(f, Fn{fa[b], fr[b]});
  }
  Fn total;
  int x = apply(warp_exclusive<false>(f, lane, &total), BIG);
  for (int v = lo; v < hi; ++v) {
    const int b = dir ? nt - 1 - v : v;
    carry[b] = x;
    x = apply(Fn{fa[b], fr[b]}, x);
  }
}

__global__ void __launch_bounds__(THREADS)
levels_apply_kernel(const int32_t* __restrict__ p, int n,
                    const uint8_t* __restrict__ lcp,
                    const int32_t* __restrict__ tiles,
                    int32_t* __restrict__ out) {
  constexpr int SPAN = TILE + 2 * HALO;
  __shared__ int sp[SPAN];
  __shared__ uint8_t sl[SPAN];
  __shared__ Fn tot[2][MAIN][WARPS];
  const int nt = gridDim.x;
  const int tile0 = blockIdx.x * TILE;
  for (int k = threadIdx.x; k < SPAN; k += THREADS) {
    const int i = tile0 - HALO + k;
    const bool in = i >= 0 && i < n;
    sp[k] = in ? p[i] : BIG;
    sl[k] = in ? lcp[i] : 0;       // lcp(0) is 0; past either end too
  }
  __syncthreads();
  const int j0 = threadIdx.x * PER;
  const int s0 = HALO + j0;
  const int i0 = tile0 + j0;
  int pv[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) pv[e] = sp[s0 + e];

  // each main level's group minimum: segmented prefix and suffix minima
  Fn fw[MAIN], bw[MAIN];
  thread_fns(sl + s0, pv, fw, bw);
  block_scan(fw, bw, tot);
  const int warp = threadIdx.x >> 5;
  int gmin[MAIN][PER];
#pragma unroll
  for (int m = 0; m < MAIN; ++m) {
    const int th = main_th(m);
    int x = tiles[carry_at(0, m, nt) + blockIdx.x];
    for (int w = 0; w < warp; ++w) x = apply(tot[0][m][w], x);
    x = apply(fw[m], x);
    int y = tiles[carry_at(1, m, nt) + blockIdx.x];
    for (int w = WARPS - 1; w > warp; --w) y = apply(tot[1][m][w], y);
    y = apply(bw[m], y);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      x = sl[s0 + e] < th ? pv[e] : min(x, pv[e]);
      gmin[m][e] = x;
    }
#pragma unroll
    for (int e = PER - 1; e >= 0; --e) {
      y = sl[s0 + e + 1] < th ? pv[e] : min(y, pv[e]);
      gmin[m][e] = min(gmin[m][e], y);
    }
  }
  if (i0 >= n) return;     // no barrier follows

  // neighbours, and the winner of every level; four entries at a time
#pragma unroll
  for (int h = 0; h < PER; h += 4) {
    int res[8][4];
#pragma unroll
    for (int e = h; e < h + 4; ++e) {
      const uint8_t* l = sl + s0 + e;
      const int* q = sp + s0 + e;
      const int pos = pv[e];
      // least lcp over (i - r, i] and over (i, i + r]
      int mb[5], mf[5];
      mb[0] = l[0];
      mf[0] = l[1];
      mb[1] = min(mb[0], int(l[-1]));
      mf[1] = min(mf[0], int(l[2]));
      mb[2] = min(mb[1], min(int(l[-2]), int(l[-3])));
      mf[2] = min(mf[1], min(int(l[3]), int(l[4])));
      mb[3] = mb[2];
      mf[3] = mf[2];
#pragma unroll
      for (int k = 4; k < 8; ++k) {
        mb[3] = min(mb[3], int(l[-k]));
        mf[3] = min(mf[3], int(l[k + 1]));
      }
      mb[4] = mb[3];
      mf[4] = mf[3];
#pragma unroll
      for (int k = 8; k < 16; ++k) {
        mb[4] = min(mb[4], int(l[-k]));
        mf[4] = min(mf[4], int(l[k + 1]));
      }
      int cb[5], cf[5];
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        cb[r] = q[-(1 << r)];
        cf[r] = q[1 << r];
      }
#pragma unroll
      for (int lev = 0; lev < 8; ++lev) {
        const int th = lev + 1;
        int best = -1;
        auto consider = [&](int c, bool ok) {
          if (ok && c < pos && pos - c <= WINDOW && c > best) best = c;
        };
        if (lev == 0) consider(gmin[0][e], true);
        if (lev == 1) consider(gmin[1][e], true);
        if (lev == 3) consider(gmin[2][e], true);
        if (lev == 7) consider(gmin[3][e], true);
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          consider(cb[r], mb[r] >= th);
          consider(cf[r], mf[r] >= th);
        }
        res[lev][e - h] = best >= 0 ? pos - best : 0;
      }
    }
#pragma unroll
    for (int lev = 0; lev < 8; ++lev)
      *reinterpret_cast<int4*>(out + size_t(lev) * n + i0 + h) =
          make_int4(res[lev][0], res[lev][1], res[lev][2], res[lev][3]);
  }
}

}  // namespace

// buf: n bytes (4-byte aligned); p: n int32 (16-byte aligned); lcp: n
// bytes of scratch; tiles: 24 int32 a tile of scratch; out: 8 x n int32
// (16-byte aligned).  n is a positive multiple of 1024.
LZ4T_API int lz4t_emit_levels(const uint8_t* buf, const int32_t* p, int n,
                              uint8_t* lcp, int32_t* tiles, int32_t* out,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int nt = (n + TILE - 1) / TILE;
    levels_tiles_kernel<<<nt, THREADS, 0, st>>>(
        reinterpret_cast<const uint32_t*>(buf), p, n, lcp, tiles);
    levels_carry_kernel<<<1, THREADS, 0, st>>>(tiles, nt);
    levels_apply_kernel<<<nt, THREADS, 0, st>>>(p, n, lcp, tiles, out);
  }
  return int(cudaGetLastError());
}
