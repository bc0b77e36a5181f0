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
// stay bytes.
//
// Bound on an H100: by bytes (each literal byte read once, each output
// byte written once) the kernel would take microseconds; what bounds it is
// the chain: a match may read what the match before it wrote, so one
// chain's matches resolve in order on one SM.  The least time is (depth of
// the chain's dependency) x (one shared-memory store-to-load round trip);
// in practice it is the instructions one warp executes per byte it
// resolves.  The design keeps the round trip in shared memory and leaves
// the resolving warp a few instructions a byte, with everything else off
// the chain.
//
// Design: one chain per block.  An LZ4 offset is at most 65,535, so the
// chain's recent output lives in a ring in dynamic shared memory (64 KiB
// where that holds every chain of the launch whole, else 128 KiB, chosen by
// the wrapper from the launch's longest chain; output byte p lies at
// ring[p mod ring]).  The output is built tile by tile
// (TILE bytes), in steps separated by one block barrier:
//
//   step s:  warps 1..7 (the producers) store tile s-1 to device memory
//            (16-byte coalesced stores), then prepare tile s+1: clear its
//            ring region, copy its literals from `comp` into it (literal
//            copies never depend on a match), and expand its matches into
//            a map of one uint16 per output byte: the match offset for a
//            byte a match writes, 0 for any other byte;
//            warp 0 (the consumer) resolves tile s in the ring with that
//            map alone, a lane a byte in output order:
//            ring[p] = ring[p - map[p]] (offset 0 copies a byte onto
//            itself).  A round takes up to 128 bytes, cut before the
//            first that reads another byte of the same round (only an
//            offset below 128 can); a run of one offset below 32 (an
//            overlapping match) folds onto the `offset` bytes before it,
//            32 bytes a round.  A round ends with one warp
//            synchronisation; the consumer touches no table and no device
//            memory.
//
// A sequence that crosses a tile edge is expanded piece by piece, each
// piece clamped to its tile; the per-byte rule needs no other care.  Bytes
// no sequence writes stay 0 (the ring region is cleared before anything
// arrives), so a tile is stored whole.  A match offset above 65,535
// (possible only in tables that are not LZ4's) reads bytes at least eight
// tiles back, which were stored to device memory several barriers
// earlier: the producers copy those from there like literals, and the map
// holds 0 for them.
//
// The table must be in output order without overlap (dst[i+1] >= dst[i] +
// lit_len[i] + match_len[i]); segment_decode.pack_chains refuses others.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NP = THREADS - 32;  // producer threads (warps 1..7)
constexpr int TILE = 8192;        // output bytes per step
constexpr int SHORT_RUN = 16;     // copies up to this: one thread
constexpr int MAX_NEAR = 65535;   // largest offset the map holds
constexpr int MAX_RING = 131072;
constexpr int MAP_BYTES = 2 * TILE * 2;   // two tiles of uint16
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NP) : "memory");
}

// What a producer thread hands its warp when a piece is too long for one
// thread: bytes [a, b) of the output, of one kind.
enum Kind { NONE = 0, LITERAL = 1, NEAR = 2, FAR = 3 };

__global__ void __launch_bounds__(THREADS)
segment_decode_kernel(const uint8_t* __restrict__ comp,
                      const int32_t* __restrict__ seqs, int64_t n_seqs,
                      const int32_t* __restrict__ chains, uint8_t* out,
                      int ring_bytes) {
  extern __shared__ uint4 smem4[];
  __shared__ int s_next[3];   // s_next[t % 3]: first sequence of tile t
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  uint16_t* map = reinterpret_cast<uint16_t*>(ring + ring_bytes);
  const int M = ring_bytes - 1;
  const int32_t* row = chains + 4 * blockIdx.x;
  const int seq_lo = row[0], seq_hi = row[1];
  if (seq_hi <= seq_lo) return;
  const uint8_t* cbase = comp + row[2];
  uint8_t* obase = out + row[3];
  const int32_t* q_dst = seqs;
  const int32_t* q_src = seqs + n_seqs;
  const int32_t* q_ll = seqs + 2 * n_seqs;
  const int32_t* q_off = seqs + 3 * n_seqs;
  const int32_t* q_ml = seqs + 4 * n_seqs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ptid = tid - 32;
  const int chain_end =
      q_dst[seq_hi - 1] + q_ll[seq_hi - 1] + q_ml[seq_hi - 1];
  const int n_tiles = (chain_end >> 13) + ((chain_end & (TILE - 1)) != 0);
  static_assert(TILE == 1 << 13, "n_tiles shifts by log2(TILE)");
  if (tid < 3) s_next[tid] = tid == 0 ? seq_lo : INT_MAX;
  __syncthreads();

  for (int s = -1; s <= n_tiles; ++s) {
    if (warp == 0) {
      if (s >= 0 && s < n_tiles) {
        const int T0 = s << 13;
        const int T1 = chain_end - T0 > TILE ? T0 + TILE : chain_end;
        const uint16_t* mp = map + (s & 1) * TILE - T0;   // mp[p], T0 <= p
        // the round's map values, a lane 4 bytes 32 apart; 0 past the tile
        auto offsets = [&](int at, int (&o)[4]) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            o[q] = at + lane + 32 * q < T1 ? mp[at + lane + 32 * q] : 0;
        };
        int cur = T0;
        int o[4];
        offsets(cur, o);
        while (cur < T1) {
          const int rem = T1 - cur;
          // up to 128 bytes, cut before the first that reads inside them
          int mine = 128;
#pragma unroll
          for (int q = 3; q >= 0; --q)
            if (o[q] != 0 && o[q] <= lane + 32 * q) mine = lane + 32 * q;
          const int lim = min(rem, __reduce_min_sync(FULL, mine));
          if (lim < 32 && lim < rem) {
            const int o0 = __shfl_sync(FULL, o[0], 0);
            if (o0 != 0 && o0 < 32) {
              // a run of one small offset (an overlapping match): its
              // bytes repeat the o0 bytes before cur; up to 32 at once
              const unsigned other =
                  __ballot_sync(FULL, lane >= rem || o[0] != o0);
              const int n = other ? __ffs(other) - 1 : 32;
              if (lane < n)
                ring[(cur + lane) & M] = ring[(cur - o0 + lane % o0) & M];
              __syncwarp();
              cur += n;
              offsets(cur, o);
              continue;
            }
          }
          uint8_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (lane + 32 * q < lim)
              v[q] = ring[(cur + lane + 32 * q - o[q]) & M];
          // the next round's map values come in behind the ring loads
          const int at = cur;
          cur += lim;
          offsets(cur, o);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (lane + 32 * q < lim) ring[(at + lane + 32 * q) & M] = v[q];
          __syncwarp();
        }
      }
    } else {
      if (s >= 1) {
        // store tile s-1: it was resolved in the last step
        const int T0 = (s - 1) << 13;
        const int n = chain_end - T0 > TILE ? TILE : chain_end - T0;
        uint8_t* g = obase + T0;
        const uint8_t* r = ring + (T0 & M);
        int done = 0;
        if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
          const int n16 = n >> 4;
          for (int k = ptid; k < n16; k += NP)
            reinterpret_cast<uint4*>(g)[k] =
                reinterpret_cast<const uint4*>(r)[k];
          done = n16 << 4;
        }
        for (int k = done + ptid; k < n; k += NP) g[k] = r[k];
      }
      if (s + 1 < n_tiles) {
        // tile s+1: clear its ring region and its map, then bring its
        // literals in and expand its matches
        const int t = s + 1;
        const int T0 = t << 13;
        const int T1 = chain_end - T0 > TILE ? T0 + TILE : chain_end;
        uint16_t* mp = map + (t & 1) * TILE - T0;
        const int jp = s_next[t % 3];
        if (ptid == 0) s_next[(t + 2) % 3] = INT_MAX;
        uint4* z = smem4 + ((T0 & M) >> 4);
        uint4* zm = reinterpret_cast<uint4*>(map + (t & 1) * TILE);
        for (int k = ptid; k < TILE / 16; k += NP)
          z[k] = make_uint4(0u, 0u, 0u, 0u);
        for (int k = ptid; k < TILE / 8; k += NP)
          zm[k] = make_uint4(0u, 0u, 0u, 0u);
        producers_sync();

        // one piece of a sequence, clamped to the tile: short ones the
        // thread does itself, long ones it hands to its warp
        auto piece = [&](int kind, int a, int b, int arg, int& w_kind,
                         int& w_a, int& w_b, int& w_arg) {
          if (b <= a) return;
          if (b - a > SHORT_RUN || kind == FAR) {
            w_kind = kind;
            w_a = a;
            w_b = b;
            w_arg = arg;
          } else if (kind == LITERAL) {
            for (int k = 0; k < b - a; k += 4) {
              uint8_t v[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (k + q < b - a) v[q] = cbase[arg + k + q];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (k + q < b - a) ring[(a + k + q) & M] = v[q];
            }
          } else {
            for (int k = a; k < b; ++k) mp[k] = uint16_t(arg);
          }
        };
        // the warp does the handed pieces together, a lane a byte
        auto together = [&](int w_kind, int w_a, int w_b, int w_arg) {
          unsigned todo = __ballot_sync(FULL, w_kind != NONE);
          while (todo) {
            const int from = __ffs(todo) - 1;
            todo &= todo - 1;
            const int kind = __shfl_sync(FULL, w_kind, from);
            const int a = __shfl_sync(FULL, w_a, from);
            const int b = __shfl_sync(FULL, w_b, from);
            const int arg = __shfl_sync(FULL, w_arg, from);
            if (kind == NEAR) {
              for (int p = a + lane; p < b; p += 32) mp[p] = uint16_t(arg);
            } else {
              // arg: literal source in comp of byte a, or the far offset
              for (int p = a + lane; p < b; p += 128) {
                uint8_t v[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int pp = p + 32 * q;
                  if (pp < b)
                    v[q] = kind == LITERAL ? cbase[arg + (pp - a)]
                                           : __ldcg(obase + pp - arg);
                }
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  if (p + 32 * q < b) ring[(p + 32 * q) & M] = v[q];
              }
            }
          }
        };

        int cand = seq_hi;          // first sequence that tile t+1 needs
        bool alive = true;
        // a sequence's five fields; the next round's are in flight while
        // this round's pieces are done
        struct Seq { int dst, src, ll, off, ml; };
        auto fetch = [&](int i) {
          Seq q = {INT_MAX, 0, 0, 1, 0};
          if (i < seq_hi)
            q = {q_dst[i], q_src[i], q_ll[i], max(q_off[i], 1), q_ml[i]};
          return q;
        };
        Seq nxt = fetch(jp + ptid);
        for (int i = jp + ptid; __any_sync(FULL, alive); i += NP) {
          const Seq sq = nxt;
          if (alive) nxt = fetch(i + NP);
          int l_kind = NONE, l_a = 0, l_b = 0, l_arg = 0;
          int m_kind = NONE, m_a = 0, m_b = 0, m_arg = 0;
          if (alive) {
            if (i >= seq_hi) {
              alive = false;
            } else if (sq.dst >= T1) {
              cand = i;
              alive = false;
            } else {
              const int md = sq.dst + sq.ll;
              const int a = max(sq.dst, T0);
              piece(LITERAL, a, min(md, T1), sq.src + (a - sq.dst), l_kind,
                    l_a, l_b, l_arg);
              if (sq.ml > 0 && md < T1 && md > T0 - sq.ml)
                piece(sq.off <= MAX_NEAR ? NEAR : FAR, max(md, T0),
                      md > T1 - sq.ml ? T1 : md + sq.ml, sq.off, m_kind, m_a,
                      m_b, m_arg);
              if (md > T1 - sq.ml) {          // it goes on in tile t+1
                cand = i;
                alive = false;
              }
            }
          }
          together(l_kind, l_a, l_b, l_arg);
          together(m_kind, m_a, m_b, m_arg);
        }
        cand = __reduce_min_sync(FULL, cand);
        if (lane == 0) atomicMin(&s_next[(t + 1) % 3], cand);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ring_bytes: 65536 (every chain of the launch fits it whole) or 131072
LZ4T_API int lz4t_segment_decode(const uint8_t* comp, const int32_t* seqs,
                                 int64_t n_seqs, const int32_t* chains,
                                 int n_chains, uint8_t* out, int ring_bytes,
                                 void* stream) {
  if (ring_bytes != MAX_RING / 2 && ring_bytes != MAX_RING)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      segment_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_RING + MAP_BYTES);
  if (e != cudaSuccess) return int(e);
  if (n_chains > 0)
    segment_decode_kernel<<<n_chains, THREADS, ring_bytes + MAP_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
        comp, seqs, n_seqs, chains, out, ring_bytes);
  return int(cudaGetLastError());
}
