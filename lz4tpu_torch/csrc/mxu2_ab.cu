// H7: mxu2 routing with the substep size as a parameter, in two designs,
// with timing-only ablations of each (the A/B harness kernel).
//
// Replaces exp/ab.py::make_kernel (K9, pallas_call at :197, launcher
// run_variant :188).  The function is H3's (mxu2.cu) with the substep
// size SUB_ a template parameter: output byte j of substep i is the known
// byte (code >> 17) & 255, or, with bit 16 set, the ring byte at code &
// 0xFFFF; after each substep its SUB_ bytes are written into the ring at
// byte offset (i * SUB_) mod 65536, wrapping past the ring's end when
// SUB_ does not divide 65536 (3072, 6144, 12288).  K9's row width (rowb)
// and bytes per bf16 digit (pack) are the TPU's one-hot routing and have
// no counterpart here.  K9's scal column holds exactly (i * SUB_ / rowb)
// mod pages, so the offset is computed from i.
//
// Bound on an H100: bytes.  Device memory sees 4 B of code in and 1 B
// out a byte; the state words of the passes stay in L2 at these sizes.
//
// The pointer-jumping design (EXACT, the decode H3 runs since it was
// rebuilt): the ring is written as one stream, so every output byte at
// absolute position q = i * SUB_ + j lands at ring offset q mod 65536,
// whatever SUB_ is, and a ring code at offset o in substep i reads the
// byte at q = i * SUB_ - 1 - ((i * SUB_ - 1 - o) mod 65536), or, when q
// < 0, ring_in[o] (0 without ring_in).  Three kernels on the caller's
// stream, one thread per 4 bytes over the whole card, as in mxu2.cu:
//   sources: each code into a state word (>= 0: the position of the byte
//     it equals; < 0: the resolved byte ~s), blocks of a fixed size over
//     the substeps' words (sub / 4 words is more than 1024 threads at 6144
//     and 12288);
//   jump (passes 1..P, P = ceil(log2(n_sub)) + 1): every pointer goes to
//     an earlier substep, so P passes resolve every chain; a pass returns
//     at once when the last one left nothing unresolved (the flag words);
//   out: the bytes of every word into rows, then ring_out from the
//     positions of the last 64 KiB (ring_in or 0 below position 0).
// Only the sources' closed form and ring_out's depend on SUB_; the jump
// and output bodies are short copies of mxu2.cu's (this file does not
// link against it).  Scratch, from the wrapper: 4 B of state a byte and
// P + 1 flags.  GRAPH is the same decode as one CUDA graph: built once
// for each (device, SUB_, n_sub, P), its nodes' arguments set to the
// call's pointers and replayed, so its time beside EXACT's is what the
// separate launches cost on the card.  At most GRAPH_CACHE executable
// graphs are kept for each SUB_, the least recently used freed first.
//
// The serial design (SERIAL, PREFETCH: the loop H3 was before): one
// block walks a chain's substeps in order, the ring in shared memory; a
// substep pays the code load from device memory, a barrier, a dependent
// shared-memory gather, a barrier, the ring write and the output store,
// on one SM.  PREFETCH issues substep i + 1's code load before substep
// i's gather.  It stays as the design the jump resolve is set beside.
//
// The ablations drop one phase each to show what it costs; their output
// is not the decode and is never compared.
#include <algorithm>
#include <list>
#include <mutex>
#include <tuple>
#include <utility>
#include <vector>

#include "common.cuh"

namespace {

using namespace lz4t;

enum Variant {
  // pointer jumping
  EXACT = 0,        // the decode
  GRAPH = 1,        // the decode, replayed as one CUDA graph
  NOJUMP = 2,       // timing only: sources and output, no pass
  NOOUT = 3,        // timing only: sources and passes, no output kernel
  SOURCES = 4,      // timing only: the sources kernel alone
  // the serial loop
  SERIAL = 5,       // the decode
  PREFETCH = 6,     // the decode, next substep's code loaded one ahead
  NOGATHER = 7,     // timing only: known byte for every code, no ring read
  NORING = 8,       // timing only: no ring write-back
  NOSTORE = 9,      // timing only: no store of the output bytes
  NOGATHER1B = 10,  // NOGATHER with the second barrier dropped
  NORING1B = 11,    // NORING with the second barrier dropped
};

// ---------------------------------------------------------------------------
// pointer jumping
// ---------------------------------------------------------------------------

constexpr int JUMP_THREADS = 256;
constexpr int JUMP_BLOCKS_PER_SM = 8;   // a full SM at <= 32 registers

// The state word of code c in a substep whose first byte is at position
// before + 1.
__device__ __forceinline__ int ab_source(int c, int before,
                                         const uint8_t* ring_in) {
  const uint32_t u = uint32_t(c);
  if (!((u >> 16) & 1u)) return ~int((u >> 17) & 255u);
  const int o = int(u & 0xFFFFu);
  const int q = before - ((before - o) & (RING - 1));
  if (q >= 0) return q;
  return ~int(ring_in ? ring_in[o] : 0);
}

// One thread a 16-byte word; SUB_ is a multiple of 1024, so a block of
// JUMP_THREADS words lies inside one substep.
template <int SUB_>
__global__ void __launch_bounds__(JUMP_THREADS)
ab_sources_kernel(const int4* __restrict__ code,
                  const uint8_t* __restrict__ ring_in,
                  int4* __restrict__ state, int* __restrict__ flags) {
  constexpr int BLOCKS = SUB_ / 4 / JUMP_THREADS;   // blocks a substep
  static_assert(BLOCKS * JUMP_THREADS * 4 == SUB_, "blocks split substeps");
  const int before = int(blockIdx.x / BLOCKS) * SUB_ - 1;
  const size_t w = size_t(blockIdx.x) * JUMP_THREADS + threadIdx.x;
  const int4 c = code[w];
  const int4 v = make_int4(ab_source(c.x, before, ring_in),
                           ab_source(c.y, before, ring_in),
                           ab_source(c.z, before, ring_in),
                           ab_source(c.w, before, ring_in));
  state[w] = v;
  const bool left = v.x >= 0 || v.y >= 0 || v.z >= 0 || v.w >= 0;
  // one flag store a block, none once it is set
  if (__syncthreads_or(left) && threadIdx.x == 0 &&
      *reinterpret_cast<volatile int*>(flags) == 0)
    flags[0] = 1;
}

// A pointer v becomes the word it points at, read from L2 (another SM may
// have written it in this pass).
__device__ __forceinline__ void ab_jump(int& v, const int* st, bool& left) {
  if (v >= 0) {
    v = __ldcg(st + v);
    left |= v >= 0;
  }
}

// One pass of pointer jumping in place (mxu2.cu's jump kernel): a write
// only replaces a pointer by one further along its chain or by its byte.
__global__ void __launch_bounds__(JUMP_THREADS)
ab_jump_kernel(int4* state, int* flags, int pass, size_t n_words) {
  if (flags[pass - 1] == 0) return;     // the last pass left nothing
  const int* st = reinterpret_cast<const int*>(state);
  bool left = false;
  for (size_t w = size_t(blockIdx.x) * JUMP_THREADS + threadIdx.x;
       w < n_words; w += size_t(gridDim.x) * JUMP_THREADS) {
    int4 v = __ldcg(state + w);
    if ((v.x & v.y & v.z & v.w) < 0) continue;   // all four resolved
    ab_jump(v.x, st, left);
    ab_jump(v.y, st, left);
    ab_jump(v.z, st, left);
    ab_jump(v.w, st, left);
    state[w] = v;
  }
  if (__syncthreads_or(left) && threadIdx.x == 0) flags[pass] = 1;
}

__device__ __forceinline__ uint32_t ab_bytes4(int4 v) {
  return uint32_t(~v.x & 255) | uint32_t(~v.y & 255) << 8 |
         uint32_t(~v.z & 255) << 16 | uint32_t(~v.w & 255) << 24;
}

// rows from the resolved state (n_words int4 words), then ring_out, 4
// bytes a thread past them: ring bytes 4r .. 4r + 3 hold the positions q
// .. q + 3 (the stream's length is a multiple of 4, so q is too).
template <int SUB_>
__global__ void __launch_bounds__(JUMP_THREADS)
ab_out_kernel(const int4* __restrict__ state,
              const uint8_t* __restrict__ ring_in, size_t n_words, int n_sub,
              uint32_t* __restrict__ out, uint32_t* __restrict__ ring_out) {
  const size_t w = size_t(blockIdx.x) * JUMP_THREADS + threadIdx.x;
  if (w < n_words) {
    out[w] = ab_bytes4(state[w]);
    return;
  }
  const int r = int(w - n_words);
  if (r >= RING / 4) return;
  const int last = n_sub * SUB_ - 1;
  const int q = last - ((last - 4 * r) & (RING - 1));
  uint32_t val = 0;
  if (q >= 0)
    val = ab_bytes4(state[q / 4]);
  else if (ring_in != nullptr)
    val = reinterpret_cast<const uint32_t*>(ring_in)[r];
  ring_out[r] = val;
}

// The launch shapes and arguments of one decode.
struct JumpArgs {
  const int4* code;
  const uint8_t* ring_in;
  int4* state;
  int* flags;
  uint32_t* out;
  uint32_t* ring_out;
  size_t n_words;
  int n_sub, passes, dev;
  unsigned src_grid, jump_grid, out_grid;
};

template <int SUB_>
cudaError_t jump_args(const int32_t* code, int n_sub, const uint8_t* ring_in,
                      uint8_t* out, uint8_t* ring_out, int passes,
                      void* scratch, JumpArgs* a) {
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  a->code = reinterpret_cast<const int4*>(code);
  a->ring_in = ring_in;
  a->n_words = size_t(n_sub) * (SUB_ / 4);
  a->state = static_cast<int4*>(scratch);
  a->flags = reinterpret_cast<int*>(a->state + a->n_words);
  a->out = reinterpret_cast<uint32_t*>(out);
  a->ring_out = reinterpret_cast<uint32_t*>(ring_out);
  a->n_sub = n_sub;
  a->passes = passes;
  a->dev = dev;
  a->src_grid = unsigned(a->n_words / JUMP_THREADS);
  a->jump_grid = unsigned(std::max<size_t>(
      1, std::min(a->n_words / JUMP_THREADS,
                  size_t(sms) * JUMP_BLOCKS_PER_SM)));
  a->out_grid = unsigned((a->n_words + RING / 4 + JUMP_THREADS - 1) /
                         JUMP_THREADS);
  return cudaSuccess;
}

// EXACT and its ablations, launched one by one on the stream.
template <int SUB_>
cudaError_t launch_jump(int variant, const JumpArgs& a, cudaStream_t st) {
  cudaError_t e =
      cudaMemsetAsync(a.flags, 0, sizeof(int) * (a.passes + 1), st);
  if (e != cudaSuccess) return e;
  if (a.n_sub > 0) {
    ab_sources_kernel<SUB_><<<a.src_grid, JUMP_THREADS, 0, st>>>(
        a.code, a.ring_in, a.state, a.flags);
    if (variant == EXACT || variant == NOOUT)
      for (int p = 1; p <= a.passes; ++p)
        ab_jump_kernel<<<a.jump_grid, JUMP_THREADS, 0, st>>>(
            a.state, a.flags, p, a.n_words);
  }
  if (variant == EXACT || variant == NOJUMP)
    ab_out_kernel<SUB_><<<a.out_grid, JUMP_THREADS, 0, st>>>(
        a.state, a.ring_in, a.n_words, a.n_sub, a.out, a.ring_out);
  return cudaGetLastError();
}

// One executable graph of EXACT's operations (memset, sources, every
// pass, output) and its nodes, whose arguments each call sets.
struct JumpGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t memset = nullptr, sources = nullptr, out = nullptr;
  std::vector<cudaGraphNode_t> jumps;
};

// The arguments of every node, pointing into one call's locals.
struct NodeParams {
  explicit NodeParams(const JumpArgs& args) : a(args) {}
  NodeParams(const NodeParams&) = delete;   // the arrays point into it
  NodeParams& operator=(const NodeParams&) = delete;
  JumpArgs a;
  int pass = 0;
  void* src_args[4] = {&a.code, &a.ring_in, &a.state, &a.flags};
  void* jump_args[4] = {&a.state, &a.flags, &pass, &a.n_words};
  void* out_args[6] = {&a.state, &a.ring_in, &a.n_words, &a.n_sub, &a.out,
                       &a.ring_out};

  cudaMemsetParams memset() const {
    cudaMemsetParams m = {};
    m.dst = a.flags;
    m.value = 0;
    m.elementSize = sizeof(int);
    m.width = size_t(a.passes) + 1;
    m.height = 1;
    return m;
  }
  template <int SUB_>
  cudaKernelNodeParams sources() {
    return {reinterpret_cast<void*>(ab_sources_kernel<SUB_>),
            dim3(a.src_grid), dim3(JUMP_THREADS), 0, src_args, nullptr};
  }
  cudaKernelNodeParams jump(int p) {
    pass = p;       // read when the node's arguments are set
    return {reinterpret_cast<void*>(ab_jump_kernel), dim3(a.jump_grid),
            dim3(JUMP_THREADS), 0, jump_args, nullptr};
  }
  template <int SUB_>
  cudaKernelNodeParams out() {
    return {reinterpret_cast<void*>(ab_out_kernel<SUB_>), dim3(a.out_grid),
            dim3(JUMP_THREADS), 0, out_args, nullptr};
  }
};

template <int SUB_>
cudaError_t build_graph(NodeParams& np, JumpGraph* g) {
  cudaError_t e = cudaGraphCreate(&g->graph, 0);
  if (e != cudaSuccess) return e;
  const cudaMemsetParams m = np.memset();
  if ((e = cudaGraphAddMemsetNode(&g->memset, g->graph, nullptr, 0, &m)) !=
      cudaSuccess)
    return e;
  cudaGraphNode_t last = g->memset;
  if (np.a.n_sub > 0) {
    cudaKernelNodeParams k = np.sources<SUB_>();
    if ((e = cudaGraphAddKernelNode(&g->sources, g->graph, &last, 1, &k)) !=
        cudaSuccess)
      return e;
    last = g->sources;
    g->jumps.resize(np.a.passes);
    for (int p = 1; p <= np.a.passes; ++p) {
      k = np.jump(p);
      if ((e = cudaGraphAddKernelNode(&g->jumps[p - 1], g->graph, &last, 1,
                                      &k)) != cudaSuccess)
        return e;
      last = g->jumps[p - 1];
    }
  }
  cudaKernelNodeParams k = np.out<SUB_>();
  if ((e = cudaGraphAddKernelNode(&g->out, g->graph, &last, 1, &k)) !=
      cudaSuccess)
    return e;
  return cudaGraphInstantiateWithFlags(&g->exec, g->graph, 0);
}

// Executable graphs kept for each SUB_, one per (device, n_sub, P).
constexpr size_t GRAPH_CACHE = 8;

void free_graph(const JumpGraph& g) {
  // a graph still queued or running is freed when it completes
  if (g.exec) cudaGraphExecDestroy(g.exec);
  if (g.graph) cudaGraphDestroy(g.graph);
}

template <int SUB_>
cudaError_t launch_graph(const JumpArgs& a, cudaStream_t st) {
  using Key = std::tuple<int, int, int>;
  static std::mutex mu;
  static std::list<std::pair<Key, JumpGraph>> graphs;  // most recent first
  cudaError_t e;
  NodeParams np(a);
  std::lock_guard<std::mutex> hold(mu);
  const Key key = std::make_tuple(a.dev, a.n_sub, a.passes);
  auto found = std::find_if(graphs.begin(), graphs.end(),
                            [&](const auto& kv) { return kv.first == key; });
  if (found == graphs.end()) {
    JumpGraph g;
    if ((e = build_graph<SUB_>(np, &g)) != cudaSuccess) {
      free_graph(g);
      return e;
    }
    if (graphs.size() == GRAPH_CACHE) {
      free_graph(graphs.back().second);
      graphs.pop_back();
    }
    graphs.emplace_front(key, g);
  } else {
    graphs.splice(graphs.begin(), graphs, found);
  }
  // this call's pointers into every node; launches already queued keep
  // theirs
  const JumpGraph& g = graphs.front().second;
  const cudaMemsetParams m = np.memset();
  if ((e = cudaGraphExecMemsetNodeSetParams(g.exec, g.memset, &m)) !=
      cudaSuccess)
    return e;
  cudaKernelNodeParams k;
  if (a.n_sub > 0) {
    k = np.sources<SUB_>();
    if ((e = cudaGraphExecKernelNodeSetParams(g.exec, g.sources, &k)) !=
        cudaSuccess)
      return e;
    for (int p = 1; p <= a.passes; ++p) {
      k = np.jump(p);
      if ((e = cudaGraphExecKernelNodeSetParams(g.exec, g.jumps[p - 1],
                                                &k)) != cudaSuccess)
        return e;
    }
  }
  k = np.out<SUB_>();
  if ((e = cudaGraphExecKernelNodeSetParams(g.exec, g.out, &k)) !=
      cudaSuccess)
    return e;
  if ((e = cudaGraphLaunch(g.exec, st)) != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the serial loop
// ---------------------------------------------------------------------------

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
                       uint8_t* ring_out, int passes, void* scratch,
                       cudaStream_t stream) {
  switch (variant) {
    case EXACT:
    case GRAPH:
    case NOJUMP:
    case NOOUT:
    case SOURCES: {
      JumpArgs a;
      const cudaError_t e = jump_args<SUB_>(code, n_sub, ring_in, out,
                                            ring_out, passes, scratch, &a);
      if (e != cudaSuccess) return e;
      return variant == GRAPH ? launch_graph<SUB_>(a, stream)
                              : launch_jump<SUB_>(variant, a, stream);
    }
#define LZ4T_AB_CASE(V)                                                   \
  case V:                                                                 \
    return launch_one<SUB_, THREADS, V>(code, n_sub, ring_in, out,        \
                                        ring_out, stream);
    LZ4T_AB_CASE(SERIAL)
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
// ring_in may be null (zero ring).  The pointer-jumping variants take
// `passes` jump passes and scratch of n_sub * sub int32 state words then
// passes + 1 int32 flags; the serial ones ignore both.
LZ4T_API int lz4t_mxu2_route_ab(const int32_t* code, int n_sub, int sub,
                                int variant, const uint8_t* ring_in,
                                uint8_t* out, uint8_t* ring_out, int passes,
                                void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sub) {
#define LZ4T_AB_SUB(SUB_, THREADS)                                        \
  case SUB_:                                                              \
    return int(launch_sub<SUB_, THREADS>(variant, code, n_sub, ring_in,   \
                                         out, ring_out, passes, scratch,  \
                                         s));
    LZ4T_AB_SUB(2048, 512)
    LZ4T_AB_SUB(3072, 768)
    LZ4T_AB_SUB(4096, 1024)
    LZ4T_AB_SUB(6144, 768)
    LZ4T_AB_SUB(12288, 1024)
#undef LZ4T_AB_SUB
    default:
      return int(cudaErrorInvalidValue);
  }
}
