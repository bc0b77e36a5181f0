// lz4core: native host engine for the TPU-native LZ4 codec.
//
// This is the CPU side of the framework: the parts of the codec that are
// control-flow heavy and byte-granular (token scanning, streaming-mode ring
// decode, xxhash32, hash-chain match finding) run here at native speed; the
// bandwidth-heavy bulk work (vectorized copy resolution, batched checksums)
// runs on the GPU (see lz4tpu_torch/device/).
//
// Behavioral parity targets (reference file:line):
//   - block sequence grammar: lib/lz4ada.adb:716-788
//   - ring/history semantics:  lib/lz4ada.adb:678-680, 845-904
//   - xxhash32:                lib/lz4ada.adb:923-1026
//
// All functions use a plain C ABI and are loaded from Python via ctypes.
// Error reporting: non-zero status codes; the Python layer re-runs failing
// inputs through the exact-message oracle to produce contract-parity
// diagnostics, so only *which* check failed matters here, plus enough
// detail for fast paths.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

// Phase profiler for lz4tpu_prep_fused (serial path only): set
// LZ4TPU_PREP_PROFILE=1 to print per-phase nanoseconds to stderr.
static inline int64_t fz_now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

// Partition instrumentation for the threaded prep (tests pin that the
// thread partitioning genuinely divides the serial loop):
// when LZ4TPU_PREP_COUNTERS=1, each
// lz4tpu_prep_fused[_pre] call records its per-range
// [sub_lo, sub_hi, n_records, n_patches] rows (serial pass: one row
// spanning every substep) into a process-global table read back via
// lz4tpu_prep_last_ranges.  Writer-locked; readers assume one prep at
// a time (the test harness's usage).
static std::mutex fz_ranges_mu;
static int64_t fz_ranges_buf[4 * 256];
static int64_t fz_ranges_n = 0;

static inline int fz_counters_enabled(void) {
    const char* v = getenv("LZ4TPU_PREP_COUNTERS");
    return v != NULL && v[0] == '1';
}

static void fz_record_ranges(const int64_t* rows, int64_t n) {
    std::lock_guard<std::mutex> g(fz_ranges_mu);
    if (n > 256) n = 256;
    fz_ranges_n = n;
    std::memcpy(fz_ranges_buf, rows, (size_t)(4 * n) * sizeof(int64_t));
}

extern "C" {

// ---------------------------------------------------------------------------
// xxhash32
// ---------------------------------------------------------------------------

static const uint32_t P1 = 2654435761u;
static const uint32_t P2 = 2246822519u;
static const uint32_t P3 = 3266489917u;
static const uint32_t P4 = 668265263u;
static const uint32_t P5 = 374761393u;

static inline uint32_t rotl32(uint32_t v, int r) {
    return (v << r) | (v >> (32 - r));
}

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only, like the reference
}

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

// Extend a match [cand, ip) forward up to maxl bytes, 8 at a time.
static inline int64_t extend_match(const uint8_t* base, int64_t cand,
                                   int64_t ip, int64_t from, int64_t maxl) {
    int64_t l = from;
    while (l + 8 <= maxl && read64(base + cand + l) == read64(base + ip + l))
        l += 8;
    while (l < maxl && base[cand + l] == base[ip + l]) ++l;
    return l;
}

typedef struct {
    uint32_t s0, s1, s2, s3;
    uint64_t total;
    uint32_t buf_size;
    uint8_t buf[16];
} xxh32_state;

void lz4tpu_xxh32_init(xxh32_state* st, uint32_t seed) {
    st->s0 = seed + P1 + P2;
    st->s1 = seed + P2;
    st->s2 = seed;
    st->s3 = seed - P1;
    st->total = 0;
    st->buf_size = 0;
}

void lz4tpu_xxh32_update(xxh32_state* st, const uint8_t* data, int64_t n) {
    st->total += (uint64_t)n;
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    if (st->buf_size) {
        while (st->buf_size < 16 && p < end) st->buf[st->buf_size++] = *p++;
        if (st->buf_size < 16) return;
        st->s0 = rotl32(st->s0 + read32(st->buf + 0) * P2, 13) * P1;
        st->s1 = rotl32(st->s1 + read32(st->buf + 4) * P2, 13) * P1;
        st->s2 = rotl32(st->s2 + read32(st->buf + 8) * P2, 13) * P1;
        st->s3 = rotl32(st->s3 + read32(st->buf + 12) * P2, 13) * P1;
        st->buf_size = 0;
    }
    uint32_t s0 = st->s0, s1 = st->s1, s2 = st->s2, s3 = st->s3;
    while (end - p >= 16) {
        s0 = rotl32(s0 + read32(p + 0) * P2, 13) * P1;
        s1 = rotl32(s1 + read32(p + 4) * P2, 13) * P1;
        s2 = rotl32(s2 + read32(p + 8) * P2, 13) * P1;
        s3 = rotl32(s3 + read32(p + 12) * P2, 13) * P1;
        p += 16;
    }
    st->s0 = s0; st->s1 = s1; st->s2 = s2; st->s3 = s3;
    while (p < end) st->buf[st->buf_size++] = *p++;
}

uint32_t lz4tpu_xxh32_final(const xxh32_state* st) {
    uint32_t h;
    if (st->total >= 16) {
        h = rotl32(st->s0, 1) + rotl32(st->s1, 7) + rotl32(st->s2, 12) +
            rotl32(st->s3, 18);
    } else {
        h = st->s2 + P5;
    }
    h += (uint32_t)st->total;
    uint32_t i = 0;
    while (i + 4 <= st->buf_size) {
        h = rotl32(h + read32(st->buf + i) * P3, 17) * P4;
        i += 4;
    }
    while (i < st->buf_size) {
        h = rotl32(h + st->buf[i] * P5, 11) * P1;
        i += 1;
    }
    h ^= h >> 15; h *= P2;
    h ^= h >> 13; h *= P3;
    h ^= h >> 16;
    return h;
}

uint32_t lz4tpu_xxh32(const uint8_t* data, int64_t n, uint32_t seed) {
    xxh32_state st;
    lz4tpu_xxh32_init(&st, seed);
    lz4tpu_xxh32_update(&st, data, n);
    return lz4tpu_xxh32_final(&st);
}

int32_t lz4tpu_xxh32_state_size(void) { return (int32_t)sizeof(xxh32_state); }

// ---------------------------------------------------------------------------
// Block decode (ring semantics identical to the reference streaming core)
// ---------------------------------------------------------------------------

enum {
    LZ4TPU_OK = 0,
    LZ4TPU_E_OFFSET_ZERO = 1,      // err_a = (unused)
    LZ4TPU_E_BACKREF_RANGE = 2,    // err_a = h_offset (negative)
    LZ4TPU_E_MATCH_AFTER_LIT = 3,  // err_a = match nibble
    LZ4TPU_E_TRUNCATED = 4,        // sequence ran past end of block input
    LZ4TPU_E_DST_OVERFLOW = 5,     // output exceeded dst capacity
    LZ4TPU_E_SEQ_OVERFLOW = 6,     // sequence table capacity exceeded
};

// Read a 255-chained variable length extension. Returns -1 on truncation.
static inline int64_t var_length(const uint8_t* src, int64_t n, int64_t* ip,
                                 int64_t base) {
    int64_t v = base;
    if (base == 15) {
        uint8_t b;
        do {
            if (*ip >= n) return -1;
            b = src[*ip];
            *ip += 1;
            v += b;
        } while (b == 255);
    }
    return v;
}

// Decode one raw LZ4 block into `buf` at position `out_pos`, with the
// reference's wrapped-ring back-reference semantics:
//   raw = out_pos - offset; raw >= 0 reads buf[raw], raw < 0 reads
//   buf[raw + out_pos_history] (the retained previous region).
// Writes may run up to 8 bytes past the logical end (wild copy); `buf`
// must have >= 8 bytes of slack beyond `buf_len`... no: buf_len IS the
// allocation; we bound every write instead (branch is off the hot path).
//
// Returns a status code; on success *new_out_pos = out_pos + produced.
// On error, err_a carries the detail (see enum comments).
int32_t lz4tpu_decode_block_ring(
    const uint8_t* src, int64_t src_len,
    uint8_t* buf, int64_t buf_len,
    int64_t out_pos, int64_t out_pos_history,
    int64_t* new_out_pos, int64_t* err_a) {
    int64_t ip = 0;
    int64_t op = out_pos;
    *err_a = 0;
    // Wild copies overshoot the logical write position by up to 15
    // bytes.  In the wrapped-ring regime bytes ahead of `op` ARE the
    // still-reachable history tail (reachable down to
    // out_pos_history - 65535), so overshoot is only safe strictly
    // below that line; with no retained history it is always safe.
    const int64_t wild_end =
        out_pos_history == 0
            ? buf_len
            : (out_pos_history - 65536 - 16 > 0
                   ? out_pos_history - 65536 - 16 : 0);
    // Shortcut guards for the dominant case (unextended token, all
    // reads/writes provably in range): lit <= 14 read as one 16-byte
    // copy, match <= 18 as 18 wild bytes.  Mirrors the structure of
    // the reference's hot loop with its suppressed checks
    // (lz4ada.adb:798-817) but gated to provably-safe regions.
    const int64_t ip_fast = src_len - 32;
    const int64_t op_fast = (wild_end < buf_len ? wild_end : buf_len) - 64;
    while (ip < src_len) {
        const uint8_t token = src[ip++];
        if (token < 0xF0 && (token & 0x0F) != 0x0F
            && ip < ip_fast && op < op_fast) {
            const int64_t litf = token >> 4;
            std::memcpy(buf + op, src + ip, 16);
            ip += litf;
            op += litf;
            const int64_t offset =
                (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
            ip += 2;
            if (offset == 0) return LZ4TPU_E_OFFSET_ZERO;
            const int64_t raw = op - offset;
            if (raw >= 0 && offset >= 18) {
                std::memcpy(buf + op, buf + raw, 18);
                op += (token & 0x0F) + 4;
                continue;
            }
            if (raw >= 0 && offset >= 8) {
                std::memcpy(buf + op, buf + raw, 8);
                std::memcpy(buf + op + 8, buf + raw + 8, 8);
                std::memcpy(buf + op + 16, buf + raw + 16, 2);
                op += (token & 0x0F) + 4;
                continue;
            }
            // small offset or history reach: generic match copy below
            int64_t mlen = (token & 0x0F) + 4;
            int64_t remaining = mlen;
            int64_t raw2 = raw;
            if (raw2 < 0) {
                const int64_t h_off = raw2 + out_pos_history;
                if (h_off < 0) {
                    *err_a = h_off;
                    return LZ4TPU_E_BACKREF_RANGE;
                }
                int64_t h_len = -raw2;
                if (h_len > remaining) h_len = remaining;
                std::memcpy(buf + op, buf + h_off, (size_t)h_len);
                op += h_len;
                remaining -= h_len;
                raw2 = 0;
            }
            while (remaining > 0) {
                int64_t chunk = op - raw2;
                if (chunk > remaining) chunk = remaining;
                std::memcpy(buf + op, buf + raw2, (size_t)chunk);
                op += chunk;
                remaining -= chunk;
            }
            continue;
        }
        int64_t lit = var_length(src, src_len, &ip, token >> 4);
        if (lit < 0) return LZ4TPU_E_TRUNCATED;
        if (ip + lit > src_len) {
            // Overlong literal run: the reference fails this at the
            // match-nibble check (lz4ada.adb:752-764); mirror that.
            if (token & 0x0F) {
                *err_a = token & 0x0F;
                return LZ4TPU_E_MATCH_AFTER_LIT;
            }
            return LZ4TPU_E_TRUNCATED;
        }
        if (lit > 0) {
            if (op + lit > buf_len) return LZ4TPU_E_DST_OVERFLOW;
            if (lit <= 16 && ip + 16 <= src_len && op + 16 <= buf_len
                && op + 16 <= wild_end) {
                // wild copy (reference: suppressed-check Write_Output,
                // lz4ada.adb:798-817): the buffer carries +8 slack and
                // short literal runs dominate text streams
                std::memcpy(buf + op, src + ip, 16);
            } else {
                std::memcpy(buf + op, src + ip, (size_t)lit);
            }
            ip += lit;
            op += lit;
        }
        if (ip >= src_len) {
            if ((token & 0x0F) != 0) {
                *err_a = token & 0x0F;
                return LZ4TPU_E_MATCH_AFTER_LIT;
            }
            break;
        }
        if (ip + 2 > src_len) return LZ4TPU_E_TRUNCATED;
        const int64_t offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0) return LZ4TPU_E_OFFSET_ZERO;
        int64_t mlen = var_length(src, src_len, &ip, token & 0x0F);
        if (mlen < 0) return LZ4TPU_E_TRUNCATED;
        mlen += 4;
        if (op + mlen > buf_len) return LZ4TPU_E_DST_OVERFLOW;

        int64_t raw = op - offset;
        int64_t remaining = mlen;
        if (raw < 0) {
            // Part replayed from the retained history region.
            const int64_t h_off = raw + out_pos_history;
            if (h_off < 0) {
                *err_a = h_off;
                return LZ4TPU_E_BACKREF_RANGE;
            }
            int64_t h_len = offset - op;  // == -raw
            if (h_len > remaining) h_len = remaining;
            std::memcpy(buf + op, buf + h_off, (size_t)h_len);
            op += h_len;
            remaining -= h_len;
            raw = 0;
        }
        if (remaining > 0 && op - raw >= 8
            && op + remaining + 8 <= buf_len
            && op + remaining + 8 <= wild_end) {
            // Wild 8-byte strides: write - read distance >= 8, so each
            // chunk never overlaps its own source, and later chunks see
            // earlier writes (correct overlap replication).
            uint8_t* d = buf + op;
            const uint8_t* s2 = buf + raw;
            int64_t n = remaining;
            op += remaining;
            remaining = 0;
            do {
                std::memcpy(d, s2, 8);
                d += 8;
                s2 += 8;
                n -= 8;
            } while (n > 0);
        }
        if (remaining > 0) {
            // Copy from [raw, op); self-overlapping when offset < length.
            int64_t dist = op - raw;
            while (remaining >= dist && dist <= 32) {
                // Double the replay window until wide enough for memcpy.
                std::memcpy(buf + op, buf + raw, (size_t)dist);
                op += dist;
                remaining -= dist;
                dist <<= 1;
            }
            while (remaining > 0) {
                int64_t chunk = op - raw;
                if (chunk > remaining) chunk = remaining;
                std::memcpy(buf + op, buf + raw, (size_t)chunk);
                op += chunk;
                remaining -= chunk;
                raw += 0;  // window origin fixed; span [raw, old op) grows
            }
        }
    }
    *new_out_pos = op;
    return LZ4TPU_OK;
}

// ---------------------------------------------------------------------------
// Sequence scan: token grammar -> flat sequence table (device pass 1)
// ---------------------------------------------------------------------------

// Scans one raw block and appends sequences as structure-of-arrays.
// For sequence s:
//   out_start[s] global output position of the sequence (out_base +
//                bytes decoded so far in this block)
//   lit_len[s]   number of literal bytes
//   lit_src[s]   offset of those literals: position inside `src` plus
//                `lit_base` (the block's offset in the whole stream)
//   match_len[s] match length (0 for a trailing literal-only sequence)
//   match_off[s] back-reference distance (undefined when match_len == 0)
// Returns the number of sequences, or -status on malformed input.
// *total_out accumulates the decoded size of the block; *min_reach the
// lowest global position any back-reference touches (INT64_MAX when
// the block has no matches) — callers compare it against the frame
// start (reference H_Offset < 0 check, lz4ada.adb:867-874) and the
// block start (B.Indep demotion).
int64_t lz4tpu_scan_sequences(
    const uint8_t* src, int64_t src_len,
    int64_t lit_base, int64_t out_base,
    int32_t* out_start, int32_t* lit_len, int32_t* lit_src,
    int32_t* match_len, int32_t* match_off,
    int64_t cap, int64_t* total_out, int64_t* min_reach) {
    int64_t ip = 0;
    int64_t s = 0;
    int64_t out = out_base;
    int64_t reach = INT64_C(0x7FFFFFFFFFFFFFFF);
    while (ip < src_len) {
        if (s >= cap) return -LZ4TPU_E_SEQ_OVERFLOW;
        const uint8_t token = src[ip++];
        int64_t lit = var_length(src, src_len, &ip, token >> 4);
        if (lit < 0) return -LZ4TPU_E_TRUNCATED;
        if (ip + lit > src_len)
            return (token & 0x0F) ? -LZ4TPU_E_MATCH_AFTER_LIT
                                  : -LZ4TPU_E_TRUNCATED;
        out_start[s] = (int32_t)out;
        lit_len[s] = (int32_t)lit;
        lit_src[s] = (int32_t)(ip + lit_base);
        ip += lit;
        out += lit;
        if (ip >= src_len) {
            if ((token & 0x0F) != 0) return -LZ4TPU_E_MATCH_AFTER_LIT;
            match_len[s] = 0;
            match_off[s] = 1;
            ++s;
            break;
        }
        if (ip + 2 > src_len) return -LZ4TPU_E_TRUNCATED;
        const int64_t offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0) return -LZ4TPU_E_OFFSET_ZERO;
        int64_t mlen = var_length(src, src_len, &ip, token & 0x0F);
        if (mlen < 0) return -LZ4TPU_E_TRUNCATED;
        mlen += 4;
        if (out - offset < reach) reach = out - offset;
        match_len[s] = (int32_t)mlen;
        match_off[s] = (int32_t)offset;
        out += mlen;
        ++s;
    }
    *total_out = out - out_base;
    *min_reach = reach;
    return s;
}

// Single-block "full" scan: lz4tpu_scan_sequences plus, in the same
// pass, the cumulative literal position column (litpos), the flat
// literal-stream extraction (the compressed bytes are cache-hot at
// parse time — cf. the prep's Write_Output-style wild copies), and
// the S/S+1 sentinel slots on starts/litpos that the fused prep's
// bisects need.  Error detection order is byte-identical to
// lz4tpu_scan_sequences (same checks, same sequence positions), so
// the single-block fast path reports the same malformed-input status
// as the generic path.  Feeds lz4tpu_prep_fused_pre, which skips its
// phase-1 (prefix sums + literal extraction) entirely.
int64_t lz4tpu_scan_block_full(
    const uint8_t* src, int64_t src_len, int64_t lit_base,
    int32_t* out_start,   // [cap + 2] (sentinels at [s], [s+1])
    int32_t* lit_len, int32_t* lit_src,
    int32_t* match_len, int32_t* match_off,
    int32_t* litpos,      // [cap + 2] (sentinels at [s], [s+1])
    uint8_t* lits, int64_t lits_cap,
    int64_t cap, int64_t* total_out, int64_t* min_reach,
    int64_t* n_lit_out, int64_t* max_off_out) {
    int64_t ip = 0;
    int64_t s = 0;
    int64_t out = 0;
    int64_t lp = 0;
    int64_t max_off = 1;
    int64_t reach = INT64_C(0x7FFFFFFFFFFFFFFF);
    while (ip < src_len) {
        if (s >= cap) return -LZ4TPU_E_SEQ_OVERFLOW;
        const uint8_t token = src[ip++];
        int64_t lit = var_length(src, src_len, &ip, token >> 4);
        if (lit < 0) return -LZ4TPU_E_TRUNCATED;
        if (ip + lit > src_len)
            return (token & 0x0F) ? -LZ4TPU_E_MATCH_AFTER_LIT
                                  : -LZ4TPU_E_TRUNCATED;
        out_start[s] = (int32_t)out;
        lit_len[s] = (int32_t)lit;
        lit_src[s] = (int32_t)(ip + lit_base);
        litpos[s] = (int32_t)lp;
        if (lit <= 16 && ip + 16 <= src_len && lp + 16 <= lits_cap) {
            memcpy(lits + lp, src + ip, 16);   // wild copy; next run
                                               // overwrites the spill
        } else if (lit) {
            if (lp + lit > lits_cap) return -LZ4TPU_E_SEQ_OVERFLOW;
            memcpy(lits + lp, src + ip, (size_t)lit);
        }
        lp += lit;
        ip += lit;
        out += lit;
        if (ip >= src_len) {
            if ((token & 0x0F) != 0) return -LZ4TPU_E_MATCH_AFTER_LIT;
            match_len[s] = 0;
            match_off[s] = 1;
            ++s;
            break;
        }
        if (ip + 2 > src_len) return -LZ4TPU_E_TRUNCATED;
        const int64_t offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0) return -LZ4TPU_E_OFFSET_ZERO;
        int64_t mlen = var_length(src, src_len, &ip, token & 0x0F);
        if (mlen < 0) return -LZ4TPU_E_TRUNCATED;
        mlen += 4;
        if (out - offset < reach) reach = out - offset;
        if (offset > max_off) max_off = offset;
        match_len[s] = (int32_t)mlen;
        match_off[s] = (int32_t)offset;
        out += mlen;
        ++s;
    }
    if (out >= INT64_C(0x7FFFFFF0) || lp >= INT64_C(0x7FFFFFF0))
        return -LZ4TPU_E_SEQ_OVERFLOW;
    out_start[s] = (int32_t)out;
    out_start[s + 1] = INT32_C(0x7FFFFFFF);
    litpos[s] = (int32_t)lp;
    litpos[s + 1] = (int32_t)lp;
    *total_out = out;
    *min_reach = reach;
    *n_lit_out = lp;
    *max_off_out = max_off;
    return s;
}

// ---------------------------------------------------------------------------
// Encoder: greedy hash-chain match finder producing standard LZ4 blocks
// ---------------------------------------------------------------------------

static inline uint32_t hash_seq(uint32_t v) {
    return (v * 2654435761u) >> (32 - 16);  // 16-bit hash table
}

// Compress one block. `hist` may point at up to 64 KiB of preceding
// output (linked blocks); pass hist_len = 0 for independent blocks.
// Returns compressed size, or -1 if it would exceed dst capacity, or 0
// for an empty input.
int64_t lz4tpu_compress_block(
    const uint8_t* hist, int64_t hist_len,
    const uint8_t* src, int64_t src_len,
    uint8_t* dst, int64_t dst_cap,
    int32_t max_chain, int32_t lazy) {
    if (src_len <= 0) return 0;

    // Work over a virtual stream: positions [0, hist_len) are history,
    // [hist_len, hist_len + src_len) are the bytes to encode.
    // We require hist to be contiguous with src when hist_len > 0
    // (callers pass a window into one buffer); otherwise hist_len == 0.
    const uint8_t* base = (hist_len > 0) ? hist : src;
    const int64_t start = hist_len;               // first pos to encode
    const int64_t end = hist_len + src_len;        // one past last

    static const int HASH_SIZE = 1 << 16;
    // Per-call tables: head[h] = most recent position + 1 (0 = empty),
    // chain[pos & 0xFFFF] links to the previous position with same hash.
    // Window is 64 KiB so a 64 Ki chain ring suffices.
    int64_t* head = new int64_t[HASH_SIZE];
    int64_t* chain = new int64_t[1 << 16];
    std::memset(head, 0, HASH_SIZE * sizeof(int64_t));
    std::memset(chain, 0, (1 << 16) * sizeof(int64_t));

    const int64_t MFLIMIT = 12;   // last 12 bytes are always literals
    const int64_t MINMATCH = 4;
    int64_t ip = start;
    int64_t anchor = start;
    int64_t op = 0;
    const int64_t match_limit = end - 5;  // last match must start 12 from end

    // Seed the tables with history positions so linked blocks can match
    // into the previous 64 KiB.
    for (int64_t p = (hist_len > (int64_t)0xFFFF ? hist_len - 0xFFFF : 0);
         hist_len > 0 && p + MINMATCH <= hist_len; ++p) {
        uint32_t h = hash_seq(read32(base + p));
        chain[p & 0xFFFF] = head[h];
        head[h] = p + 1;
    }

    #define EMIT_FAIL { delete[] head; delete[] chain; return -1; }

    // Search the hash chain for the longest match at position p.
    // Inserts p into the tables as a side effect.
    int64_t last_inserted = -1;  // highest position added to the tables
    auto find_match = [&](int64_t p, int64_t* pos_out) -> int64_t {
        last_inserted = p;
        uint32_t h = hash_seq(read32(base + p));
        int64_t best_len = 0;
        int64_t cand = head[h] - 1;
        int tries = max_chain;
        const int64_t maxl = match_limit - p;
        while (cand >= 0 && cand + 0xFFFF >= p && tries-- > 0) {
            // one-byte pre-test: a candidate that cannot beat best_len
            // differs at position best_len; rejects most of the chain
            // on repetitive data with a single load
            if (cand < p
                && (best_len == 0 || base[cand + best_len] == base[p + best_len])
                && read32(base + cand) == read32(base + p)) {
                int64_t l = MINMATCH;
                while (l < maxl && base[cand + l] == base[p + l]) ++l;
                if (l >= MINMATCH && l > best_len) {
                    best_len = l;
                    *pos_out = cand;
                }
                if (best_len >= maxl) break;  // cannot improve
            }
            int64_t next = chain[cand & 0xFFFF] - 1;
            if (next >= cand) break;  // stale ring entry: stop the walk
            cand = next;
        }
        chain[p & 0xFFFF] = head[h];
        head[h] = p + 1;
        return best_len;
    };

    // Skip acceleration (the classic LZ4 fast-path trade): after ~64
    // consecutive miss positions the stride between attempted
    // positions grows, so incompressible regions cost O(n/step)
    // searches instead of O(n). Skipped positions are not inserted —
    // a deliberate ratio-for-speed trade reset on every found match.
    int64_t search_count = 1 << 6;
    while (ip + MFLIMIT <= end) {
        int64_t best_pos = -1;
        int64_t best_len = find_match(ip, &best_pos);
        if (best_len < MINMATCH) {
            ip += search_count++ >> 6;
            continue;
        }
        search_count = 1 << 6;

        // Lazy evaluation: a longer match starting one byte later wins
        // (repeat while it keeps improving).
        while (lazy && ip + 1 + MFLIMIT <= end) {
            int64_t pos1 = -1;
            int64_t len1 = find_match(ip + 1, &pos1);
            if (len1 > best_len + 1) {
                best_len = len1;
                best_pos = pos1;
                ++ip;
            } else {
                break;
            }
        }

        // Extend the match backwards over pending literals.
        while (ip > anchor && best_pos > 0 &&
               base[best_pos - 1] == base[ip - 1]) {
            --ip;
            --best_pos;
            ++best_len;
        }

        // Emit sequence: literals [anchor, ip) + match (best_pos, best_len).
        const int64_t lit = ip - anchor;
        const int64_t offset = ip - best_pos;
        int64_t mtoken = best_len - MINMATCH;
        // token + worst-case length extensions + literals + offset
        if (op + 1 + lit / 255 + 1 + lit + 2 + mtoken / 255 + 1 > dst_cap)
            EMIT_FAIL;
        uint8_t* tok = dst + op++;
        *tok = 0;
        if (lit >= 15) {
            *tok = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
        dst[op++] = (uint8_t)(offset & 0xFF);
        dst[op++] = (uint8_t)(offset >> 8);
        if (mtoken >= 15) {
            *tok |= 15;
            int64_t rest = mtoken - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok |= (uint8_t)mtoken;
        }

        // Insert skipped positions into the chain (stride for speed on
        // very long matches; dense elsewhere for ratio). Positions up to
        // last_inserted are already in the tables — re-inserting one
        // would self-loop its chain entry.
        const int64_t insert_end = ip + best_len;
        int64_t step = best_len >= 65536 ? 16 : 1;
        for (int64_t p = last_inserted + 1;
             p < insert_end && p + MINMATCH <= end; p += step) {
            uint32_t hh = hash_seq(read32(base + p));
            chain[p & 0xFFFF] = head[hh];
            head[hh] = p + 1;
            last_inserted = p;
        }
        ip += best_len;
        anchor = ip;
    }

    // Final literals.
    {
        const int64_t lit = end - anchor;
        if (op + 1 + lit / 255 + 1 + lit > dst_cap) EMIT_FAIL;
        if (lit >= 15) {
            dst[op++] = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            dst[op++] = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
    }
    #undef EMIT_FAIL

    delete[] head;
    delete[] chain;
    return op;
}

// Emitter for device-generated match candidates (lz4tpu/device/encode.py):
// cand is (k_cands, n) row-major; cand[k*n + p] is the (k+1)-th nearest
// previous position with the same 4 bytes (-1 = none within 64 KiB),
// computed on the TPU by gram sorting. This walk only verifies/extends/
// emits, keeping the longest candidate per position — no searching.
// One-step lazy deferral like lz4tpu_compress_block.
int64_t lz4tpu_compress_block_cands(
    const uint8_t* base, int64_t hist_len, int64_t src_len,
    const int32_t* cand, int32_t k_cands,
    uint8_t* dst, int64_t dst_cap, int32_t lazy) {
    if (src_len <= 0) return 0;
    const int64_t start = hist_len;
    const int64_t end = hist_len + src_len;
    const int64_t n_all = hist_len + src_len;
    const int64_t MFLIMIT = 12;
    const int64_t MINMATCH = 4;
    const int64_t match_limit = end - 5;
    int64_t ip = start;
    int64_t anchor = start;
    int64_t op = 0;

    auto match_at = [&](int64_t p, int64_t* pos_out) -> int64_t {
        int64_t best = 0;
        const int64_t maxl = match_limit - p;
        for (int32_t k = 0; k < k_cands; ++k) {
            int64_t c = cand[(int64_t)k * n_all + p];
            if (c < 0 || c + 0xFFFF < p) break;  // depths only get older
            if (best > 0 && base[c + best] != base[p + best]) continue;
            if (read32(base + c) != read32(base + p)) continue;  // safety
            int64_t l = extend_match(base, c, p, MINMATCH, maxl);
            if (l > best) { best = l; *pos_out = c; }
            if (best >= maxl) break;
        }
        return best;
    };

    #define CEMIT_FAIL return -1
    while (ip + MFLIMIT <= end) {
        int64_t best_pos = -1;
        int64_t best_len = match_at(ip, &best_pos);
        if (best_len < MINMATCH) {
            ++ip;
            continue;
        }
        if (lazy) {
            while (ip + 1 + MFLIMIT <= end) {
                int64_t pos1 = -1;
                int64_t len1 = match_at(ip + 1, &pos1);
                if (len1 > best_len + 1) {
                    best_len = len1;
                    best_pos = pos1;
                    ++ip;
                } else {
                    break;
                }
            }
        }
        while (ip > anchor && best_pos > 0 &&
               base[best_pos - 1] == base[ip - 1]) {
            --ip; --best_pos; ++best_len;
        }
        const int64_t lit = ip - anchor;
        const int64_t offset = ip - best_pos;
        int64_t mtoken = best_len - MINMATCH;
        if (op + 1 + lit / 255 + 1 + lit + 2 + mtoken / 255 + 1 > dst_cap)
            CEMIT_FAIL;
        uint8_t* tok = dst + op++;
        *tok = 0;
        if (lit >= 15) {
            *tok = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
        dst[op++] = (uint8_t)(offset & 0xFF);
        dst[op++] = (uint8_t)(offset >> 8);
        if (mtoken >= 15) {
            *tok |= 15;
            int64_t rest = mtoken - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok |= (uint8_t)mtoken;
        }
        ip += best_len;
        anchor = ip;
    }
    {
        const int64_t lit = end - anchor;
        if (op + 1 + lit / 255 + 1 + lit > dst_cap) CEMIT_FAIL;
        if (lit >= 15) {
            dst[op++] = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            dst[op++] = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
    }
    #undef CEMIT_FAIL
    return op;
}

// ---------------------------------------------------------------------------
// Optimal-parse encoder (exact LZ4 pricing via backward DP)
// ---------------------------------------------------------------------------

static inline int64_t ext_len_price(int64_t v) {
    // extra bytes to encode a 4-bit length field value of v (v = litlen
    // or matchlen-4): 0 if < 15, else 1 + (v-15)/255
    return v < 15 ? 0 : 1 + (v - 15) / 255;
}

// Optimal parse: per position longest match (hash chain), then a
// backward DP over exact sequence prices:
//   cost[i] = min( LIT(n-i),
//                  min_j  1 + ext(j-i) + (j-i) + B[j] )
//   B[j]    = min_m  2 + ext(m-4) + cost[j+m]
// The literal-run coupling is handled exactly for runs < 15 via a
// sliding-window minimum and for runs >= 15 via a suffix minimum
// (runs >= 270 may price 1 byte optimistically; the all-literal LIT
// candidate keeps the emitted stream always valid and near-optimal).
int64_t lz4tpu_compress_block_opt(
    const uint8_t* hist, int64_t hist_len,
    const uint8_t* src, int64_t src_len,
    uint8_t* dst, int64_t dst_cap,
    int32_t max_chain) {
    if (src_len <= 0) return 0;
    const uint8_t* base = (hist_len > 0) ? hist : src;
    const int64_t start = hist_len;
    const int64_t end = hist_len + src_len;
    const int64_t n = src_len;

    static const int HASH_SIZE = 1 << 16;
    int64_t* head = new int64_t[HASH_SIZE]();
    int64_t* chain = new int64_t[1 << 16]();
    int32_t* mlen = new int32_t[n];     // longest match at start+i
    int32_t* moff = new int32_t[n];

    for (int64_t p = (hist_len > 0xFFFF ? hist_len - 0xFFFF : 0);
         hist_len > 0 && p + 4 <= hist_len; ++p) {
        uint32_t h = hash_seq(read32(base + p));
        chain[p & 0xFFFF] = head[h];
        head[h] = p + 1;
    }

    const int64_t match_limit = end - 5;   // matches end at most here
    const int64_t last_start = end - 12;   // matches start at most here
    int64_t capped_off = 0;                // carry for limit-capped matches
    for (int64_t ip = start; ip < end; ++ip) {
        const int64_t i = ip - start;
        mlen[i] = 0;
        moff[i] = 0;
        if (ip <= last_start) {
            // A previous match that ran into match_limit stays maximal
            // when shifted forward: reuse it instead of re-extending
            // (turns runs/periodic data from O(n^2) into O(n)).
            if (capped_off > 0 && match_limit - ip >= 4) {
                mlen[i] = (int32_t)(match_limit - ip);
                moff[i] = (int32_t)capped_off;
                uint32_t h0 = hash_seq(read32(base + ip));
                chain[ip & 0xFFFF] = head[h0];
                head[h0] = ip + 1;
                continue;
            }
            uint32_t h = hash_seq(read32(base + ip));
            int64_t cand = head[h] - 1;
            int tries = max_chain;
            int64_t best = 0, bpos = -1;
            const int64_t maxl = match_limit - ip;
            while (cand >= 0 && cand + 0xFFFF >= ip && tries-- > 0) {
                if (cand < ip
                    && (best == 0 || base[cand + best] == base[ip + best])
                    && read32(base + cand) == read32(base + ip)) {
                    int64_t l = extend_match(base, cand, ip, 4, maxl);
                    if (l >= 4 && l > best) { best = l; bpos = cand; }
                    if (best >= maxl) break;  // cannot improve
                }
                int64_t next = chain[cand & 0xFFFF] - 1;
                if (next >= cand) break;
                cand = next;
            }
            if (best >= 4) {
                mlen[i] = (int32_t)best;
                moff[i] = (int32_t)(ip - bpos);
                capped_off = (best >= maxl) ? (ip - bpos) : 0;
            } else {
                capped_off = 0;
            }
            chain[ip & 0xFFFF] = head[h];
            head[h] = ip + 1;
        } else {
            capped_off = 0;
        }
    }
    delete[] head;
    delete[] chain;

    // Backward DP.
    const int64_t INF = INT64_C(1) << 50;
    int64_t* cost = new int64_t[n + 1];
    int32_t* pick_m = new int32_t[n + 1]();   // chosen match len at j (B[j])
    int64_t* bestB = new int64_t[n + 1];
    int32_t* pick_j = new int32_t[n + 1]();   // chosen match start from i
    // sliding-window min of key(j) = B[j] + j over window [i, i+14]
    int64_t* suffix_min = new int64_t[n + 2];
    // monotonic deque over indices
    int64_t* dq = new int64_t[n + 1];
    int64_t dq_lo = 0, dq_hi = 0;  // [lo, hi)

    cost[n] = 0;
    suffix_min[n] = INF;
    suffix_min[n + 1] = INF;
    for (int64_t i = n - 1; i >= 0; --i) {
        // B[i]: best match-part price if a match starts exactly at i.
        // Candidate lengths: all token-only lengths (4..18), the
        // maximum, a few just below it, and the extension-byte segment
        // boundaries near the maximum — longer candidates within a
        // segment always dominate on price ties, so this set preserves
        // optimality in practice while keeping the DP O(n).
        int64_t B = INF;
        int32_t bm = 0;
        const int64_t L = mlen[i];
        auto try_m = [&](int64_t m) {
            if (m < 4 || m > L) return;
            int64_t c = 2 + ext_len_price(m - 4) + cost[i + m];
            if (c < B) { B = c; bm = (int32_t)m; }
        };
        const int64_t short_top = L < 18 ? L : 18;
        for (int64_t m = 4; m <= short_top; ++m) try_m(m);
        if (L > 18) {
            for (int64_t m = L; m > L - 4 && m > 18; --m) try_m(m);
            // mext segment boundaries: 18, 273, 528, ... (last length
            // before another extension byte is needed)
            const int64_t seg = (L - 19) / 255;
            for (int64_t k = 0; k < 4 && seg - k >= 0; ++k)
                try_m(18 + 255 * (seg - k));
        }
        bestB[i] = B;
        pick_m[i] = bm;

        // push i into the window structures
        const int64_t key = (B >= INF) ? INF : B + i;
        while (dq_hi > dq_lo && (bestB[dq[dq_hi - 1]] >= INF
               ? INF : bestB[dq[dq_hi - 1]] + dq[dq_hi - 1]) >= key)
            --dq_hi;
        dq[dq_hi++] = i;
        while (dq[dq_lo] > i + 14) ++dq_lo;  // never triggers here; kept
        suffix_min[i] = key < suffix_min[i + 1] ? key : suffix_min[i + 1];

        // candidate: all-literal tail
        int64_t best = 1 + ext_len_price(n - i) + (n - i);
        int64_t bj = -1;
        // candidate: short literal run (< 15) then a match — exact
        // evict deque entries beyond the window [i, i+14]
        while (dq_hi > dq_lo && dq[dq_lo] > i + 14) ++dq_lo;
        if (dq_hi > dq_lo) {
            int64_t j = dq[dq_lo];
            int64_t k = bestB[j] >= INF ? INF : bestB[j] + j;
            if (k < INF) {
                int64_t c = 1 + (k - i);
                if (c < best) { best = c; bj = j; }
            }
        }
        // candidate: literal run >= 15 then a match
        if (i + 15 <= n - 1 && suffix_min[i + 15] < INF) {
            int64_t c = 2 + (suffix_min[i + 15] - i);
            if (c < best) {
                best = c;
                bj = -2;  // resolved during emission by re-scan
            }
        }
        cost[i] = best;
        pick_j[i] = (int32_t)(bj >= 0 ? bj : bj);
    }

    // Emission.
    #define OPT_FAIL { delete[] cost; delete[] pick_m; delete[] bestB; \
                       delete[] pick_j; delete[] suffix_min; delete[] dq; \
                       delete[] mlen; delete[] moff; return -1; }
    int64_t op = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t j;
        if (pick_j[i] == -1) {
            j = n;  // tail literals
        } else if (pick_j[i] == -2) {
            // long-run choice: find the j >= i+15 achieving suffix_min
            j = i + 15;
            while (j < n && ((bestB[j] >= INF ? INF : bestB[j] + j)
                             != suffix_min[i + 15]))
                ++j;
        } else {
            j = pick_j[i];
        }
        const int64_t lit = j - i;
        if (j >= n) {
            if (op + 1 + ext_len_price(lit) + lit > dst_cap) OPT_FAIL;
            if (lit >= 15) {
                dst[op++] = 15 << 4;
                int64_t rest = lit - 15;
                while (rest >= 255) { dst[op++] = 255; rest -= 255; }
                dst[op++] = (uint8_t)rest;
            } else {
                dst[op++] = (uint8_t)(lit << 4);
            }
            std::memcpy(dst + op, src + i, (size_t)lit);
            op += lit;
            break;
        }
        const int64_t m = pick_m[j];
        const int64_t off = moff[j];
        if (op + 1 + ext_len_price(lit) + lit + 2 + ext_len_price(m - 4) + 1
            > dst_cap)
            OPT_FAIL;
        uint8_t* tok = dst + op++;
        *tok = 0;
        if (lit >= 15) {
            *tok = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, src + i, (size_t)lit);
        op += lit;
        dst[op++] = (uint8_t)(off & 0xFF);
        dst[op++] = (uint8_t)(off >> 8);
        if (m - 4 >= 15) {
            *tok |= 15;
            int64_t rest = m - 4 - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok |= (uint8_t)(m - 4);
        }
        i = j + m;
    }
    #undef OPT_FAIL

    delete[] cost; delete[] pick_m; delete[] bestB; delete[] pick_j;
    delete[] suffix_min; delete[] dq; delete[] mlen; delete[] moff;
    return op;
}

// ---------------------------------------------------------------------------
// v2 dense pack: per-byte provenance resolution (device/mxu2.py).
// Each output byte's code is either a known value (bit 16 clear,
// byte in bits 17..24: literals and match bytes whose intra-substep
// chain terminates at a literal) or a history-ring position (bit 16
// set, source position mod 64 Ki in bits 0..15).  Memoized: code[s]
// for s in the same 2 KiB substep is already final, so inheritance is
// one copy — the per-byte generalization of the reference's
// overlapping-match replay (lib/lz4ada.adb:893-903).
// Branch-minimal run-level resolver for output bytes [j, j_hi) of a
// chain, starting at sequence `i0` with `skip` bytes of that sequence
// already emitted by an earlier range.  Wild (8-wide) writes are used
// only while j + 8 <= wild_end, so substep-aligned ranges can pack in
// parallel: ring codes read nothing, inherit codes read only within
// their own 2 KiB substep (which lies inside the range), and no write
// crosses the range end.
//
// Two dominant fast paths (measured on text streams: ~0.7 literal +
// ~4.4 match bytes per sequence, match offsets usually > 2048):
//   * literals <= 8: one 8-byte load expanded to eight code words
//   * off >= 2048: within any substep j - sub_base < 2048 <= off, so
//     the whole match is a ring reference — an affine fill of
//     consecutive mod-64Ki positions
// Everything else (long literals, 64 Ki wrap, off < 2048) falls to a
// segmented path that splits at substep boundaries: a ring fill while
// s < sub_base, then an intra-substep inherit — an overlap-replicating
// copy of already-final codes with period `off` (doubling windows like
// the reference's replay, lib/lz4ada.adb:893-903).
// Mechanical token emitter for the device-emission prototype: the
// device has already decided, per position, a QUANTIZED match length
// (0/4/8/16/32, guaranteed-correct by the gram-ladder sorts) and its
// offset.  This function only walks the block linearly and splices the
// token stream — no searching, no byte comparison, no extension (the
// LZ4 grammar emitted: lib/lz4ada.adb:716-788 is the decode side).
// Returns bytes written, or -1 on dst overflow.
int64_t lz4tpu_emit_quantized(
    const uint8_t* buf,       // [hist_len + src_len] joined buffer
    int64_t hist_len, int64_t src_len,
    const uint16_t* elen,     // [hist_len + src_len] 0 = literal
    const uint16_t* eoff,     // [hist_len + src_len]
    uint8_t* dst, int64_t cap) {
    const int64_t end = hist_len + src_len;
    int64_t p = hist_len, o = 0, lit_start = hist_len;
    // standard LZ4 end rules: last 5 bytes are literals, and a match
    // must not run into them
    const int64_t match_end_cap = end - 5;
    while (p < end) {
        int64_t L = elen[p];
        // Prefix-truncate a match that would run into the 5-byte
        // end-literal zone (a prefix of a valid match is valid) —
        // without this, tiny blocks lose their only match entirely.
        if (L > match_end_cap - p) L = match_end_cap - p;
        if (L >= 4 && eoff[p] > 0) {
            // Arithmetic run merge: an adjacent decision at the SAME
            // offset concatenates into one longer match (two matches
            // at equal distance over adjacent spans are one match —
            // still no byte comparison).  The device's log-doubling
            // only merges power-of-two aligned pairs, so e.g. a
            // 992-byte run arrives as 512+256+128+64+32; this splices
            // it into a single token.
            for (;;) {
                const int64_t L_before = L;
                while (p + L < match_end_cap && elen[p + L] >= 4
                       && eoff[p + L] == eoff[p]) {
                    int64_t ext = elen[p + L];
                    if (ext > match_end_cap - (p + L))
                        ext = match_end_cap - (p + L);
                    L += ext;
                    if (ext < elen[p + L - ext]) break;  // truncated
                }
                // Bounded forward extension: the match is guaranteed
                // for L bytes by construction; extending while the
                // actual bytes agree recovers the 1..3-byte residue
                // the 4-byte level quantization drops.  These are the
                // only byte compares in this emitter, and every
                // successful compare advances p, so the total stays
                // O(block).  Loop back: the extension can land on a
                // same-offset follow-up decision, which merges
                // arithmetically again.
                {
                    const int64_t dd = (int64_t)eoff[p];
                    while (p + L < match_end_cap
                           && buf[p + L] == buf[p + L - dd]) ++L;
                }
                if (L == L_before) break;
            }
            const int64_t lit = p - lit_start;
            const int64_t ml = L - 4;
            // token + ext lit lens + literals + offset + ext match len
            int64_t need = 1 + (lit >= 15 ? (lit - 15) / 255 + 1 : 0)
                           + lit + 2 + (ml >= 15 ? (ml - 15) / 255 + 1 : 0);
            if (o + need > cap) return -1;
            int64_t lt = lit < 15 ? lit : 15;
            int64_t mt = ml < 15 ? ml : 15;
            dst[o++] = (uint8_t)((lt << 4) | mt);
            if (lit >= 15) {
                int64_t r = lit - 15;
                while (r >= 255) { dst[o++] = 255; r -= 255; }
                dst[o++] = (uint8_t)r;
            }
            memcpy(dst + o, buf + lit_start, (size_t)lit);
            o += lit;
            dst[o++] = (uint8_t)(eoff[p] & 255);
            dst[o++] = (uint8_t)(eoff[p] >> 8);
            if (ml >= 15) {
                int64_t r = ml - 15;
                while (r >= 255) { dst[o++] = 255; r -= 255; }
                dst[o++] = (uint8_t)r;
            }
            p += L;
            lit_start = p;
        } else {
            ++p;
        }
    }
    // final literals-only sequence (match nibble 0 is legal at block
    // end: lz4ada.adb:752-764)
    const int64_t lit = p - lit_start;
    int64_t need = 1 + (lit >= 15 ? (lit - 15) / 255 + 1 : 0) + lit;
    if (o + need > cap) return -1;
    dst[o++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
    if (lit >= 15) {
        int64_t r = lit - 15;
        while (r >= 255) { dst[o++] = 255; r -= 255; }
        dst[o++] = (uint8_t)r;
    }
    memcpy(dst + o, buf + lit_start, (size_t)lit);
    o += lit;
    return o;
}


static int64_t pack_dense2_range(
    const uint8_t* buf, int64_t buf_len,
    const int32_t* ll, const int32_t* ls,
    const int32_t* ml, const int32_t* mo,
    int64_t n_seqs, int64_t i0, int64_t skip,
    int64_t j, int64_t j_hi, int32_t* code, int64_t wild_end) {
    const int64_t lit_wild_lim = buf_len - 8;
    for (int64_t i = i0; i < n_seqs && j < j_hi; ++i) {
        int64_t l = ll[i];
        int64_t m = ml[i];
        int64_t lit_from = 0;
        int64_t match_from = 0;
        if (skip > 0) {              // first sequence of a range
            lit_from = skip < l ? skip : l;
            match_from = skip - lit_from;
            skip = 0;
        }
        const uint8_t* lp = buf + ls[i];
        int64_t lit_n = l - lit_from;
        if (lit_n > j_hi - j) lit_n = j_hi - j;
        if (lit_n > 0) {
            if (lit_n <= 8 && lit_from == 0 && ls[i] <= lit_wild_lim
                && j + 8 <= wild_end) {
                const uint64_t w = read64(lp);
                for (int64_t k = 0; k < 8; ++k)
                    code[j + k] = (int32_t)((w >> (8 * k)) & 255) << 17;
            } else {
                for (int64_t k = 0; k < lit_n; ++k)
                    code[j + k] = ((int32_t)lp[lit_from + k]) << 17;
            }
            j += lit_n;
        }
        if (m == 0 || j >= j_hi) continue;
        const int64_t off = mo[i] >= 1 ? mo[i] : 1;
        int64_t mm = m - match_from;
        if (mm > j_hi - j) mm = j_hi - j;
        if (mm <= 0) continue;
        const int64_t s0 = j - off;
        if (s0 < 0) return -2;  // backref before chain
        const int64_t q = s0 & 0xFFFF;
        if (off >= 2048 && q + mm <= 65536) {
            const int32_t v = (int32_t)q | 0x10000;
            if (mm <= 8 && j + 8 <= wild_end) {
                for (int64_t k = 0; k < 8; ++k)
                    code[j + k] = v + (int32_t)k;
            } else {
                for (int64_t k = 0; k < mm; ++k)
                    code[j + k] = v + (int32_t)k;
            }
            j += mm;
            continue;
        }
        if (off >= 2048) {
            // ring fill that wraps 64 Ki — possibly several times for
            // matches longer than the ring (positions stay mod 64 Ki)
            int64_t k = 0;
            int64_t q0 = q;
            while (k < mm) {
                int64_t run = 65536 - q0;
                if (run > mm - k) run = mm - k;
                const int32_t v = (int32_t)q0 | 0x10000;
                for (int64_t t = 0; t < run; ++t)
                    code[j + k + t] = v + (int32_t)t;
                k += run;
                q0 = 0;
            }
            j += mm;
            continue;
        }
        const int64_t jend = j + mm;
        while (j < jend) {
            const int64_t sub_base = j & ~(int64_t)2047;
            int64_t seg_end = sub_base + 2048;
            if (seg_end > jend) seg_end = jend;
            int64_t a_end = sub_base + off;  // while s < sub_base
            if (a_end > seg_end) a_end = seg_end;
            if (j < a_end) {
                // off < 2048 never wraps the 64 Ki ring inside one run
                const int32_t v = (int32_t)((j - off) & 0xFFFF) | 0x10000;
                const int64_t run = a_end - j;
                for (int64_t k = 0; k < run; ++k)
                    code[j + k] = v + (int32_t)k;
                j = a_end;
            }
            if (j < seg_end) {
                const int64_t run = seg_end - j;
                if (off == 1) {
                    const int32_t v = code[j - 1];
                    for (int64_t k = 0; k < run; ++k) code[j + k] = v;
                } else {
                    int64_t k = 0, w = off;
                    while (k < run) {
                        int64_t chunk = w < run - k ? w : run - k;
                        std::memcpy(code + j + k, code + j + k - w,
                                    (size_t)chunk * sizeof(int32_t));
                        k += chunk;
                        if (w < (int64_t)1 << 30) w <<= 1;
                    }
                }
                j = seg_end;
            }
        }
    }
    return j;
}

// Parallel resolver: substep-aligned ranges packed by worker threads.
// Safe by construction (see pack_dense2_range); bit-identical to the
// serial path.  `n_threads <= 1` packs the whole chain on the caller.
int64_t lz4tpu_pack_dense2_par(
    const uint8_t* buf, int64_t buf_len,
    const int32_t* ll, const int32_t* ls,
    const int32_t* ml, const int32_t* mo,
    int64_t n_seqs, int32_t* code, int64_t cap, int32_t n_threads) {
    int64_t n_out = 0;
    for (int64_t i = 0; i < n_seqs; ++i) n_out += ll[i] + ml[i];
    if (n_out + 16 > cap) return -1;
    const int64_t n_sub = (n_out + 2047) / 2048;
    if (n_threads <= 1 || n_sub < 4 * (int64_t)n_threads) {
        int64_t j = pack_dense2_range(buf, buf_len, ll, ls, ml, mo,
                                      n_seqs, 0, 0, 0, n_out, code, cap);
        if (j < 0) return j;
        // Wild writes may scribble up to 16 codes past the end; the
        // caller packs into pre-zeroed padded storage: restore zeros.
        if (j < cap) {
            const int64_t z = (cap - j < 16) ? cap - j : 16;
            std::memset(code + j, 0, (size_t)z * sizeof(int32_t));
        }
        return j;
    }

    // Range starts: substep-aligned byte positions plus, per range, the
    // first sequence index and the bytes of it already consumed.
    const int64_t subs_per = (n_sub + n_threads - 1) / n_threads;
    std::vector<int64_t> r_j, r_seq, r_skip;
    {
        int64_t next = 0;          // next range boundary (bytes)
        int64_t acc = 0;           // output start of sequence i
        int64_t i = 0;
        while (next < n_out) {
            while (i < n_seqs && acc + ll[i] + ml[i] <= next) {
                acc += ll[i] + ml[i];
                ++i;
            }
            r_j.push_back(next);
            r_seq.push_back(i);
            r_skip.push_back(next - acc);
            next += subs_per * 2048;
        }
    }
    const size_t n_ranges = r_j.size();
    std::vector<int64_t> status(n_ranges, 0);
    std::vector<std::thread> workers;
    size_t spawned = 0;
    auto run_range = [&](size_t r) {
        const int64_t j_lo = r_j[r];
        const int64_t j_hi = (r + 1 < n_ranges) ? r_j[r + 1] : n_out;
        const int64_t wild_end = (r + 1 < n_ranges) ? j_hi : cap;
        const int64_t seq0 = r_seq[r];
        const int64_t skip0 = r_skip[r];
        status[r] = pack_dense2_range(buf, buf_len, ll, ls, ml, mo,
                                      n_seqs, seq0, skip0, j_lo, j_hi,
                                      code, wild_end);
    };
    // spawn workers for all but the last range (the caller packs that
    // one itself); on thread exhaustion, finish the rest serially
    try {
        for (size_t r = 0; r + 1 < n_ranges; ++r) {
            workers.emplace_back(run_range, r);
            ++spawned;
        }
    } catch (...) {
        // fall through: ranges [spawned, n_ranges-1) run below
    }
    for (size_t r = spawned; r + 1 < n_ranges; ++r) run_range(r);
    run_range(n_ranges - 1);
    for (auto& w : workers) w.join();
    for (size_t r = 0; r < n_ranges; ++r)
        if (status[r] < 0) return status[r];
    if (n_out < cap) {
        const int64_t z = (cap - n_out < 16) ? cap - n_out : 16;
        std::memset(code + n_out, 0, (size_t)z * sizeof(int32_t));
    }
    return n_out;
}

int64_t lz4tpu_pack_dense2(
    const uint8_t* buf, int64_t buf_len,
    const int32_t* ll, const int32_t* ls,
    const int32_t* ml, const int32_t* mo,
    int64_t n_seqs, int32_t* code, int64_t cap) {
    return lz4tpu_pack_dense2_par(buf, buf_len, ll, ls, ml, mo, n_seqs,
                                  code, cap, 1);
}


// ---------------------------------------------------------------------------
// Fused-engine prep (device/fused.py): per-substep scalars, sequence
// delta records and in-substep patch records — the O(S) host side of
// the fused kernel.  Layout/encoding contracts mirror fused.prep_fused
// exactly (differential-tested); patch slot order within a substep is
// unspecified (the kernel scatter is order-independent).
// ---------------------------------------------------------------------------

#define FZ_SUB 2048
#define FZ_SUB_SHIFT 11
#define FZ_SEQ_MAX 576
#define FZ_PATCH_MAX 256
#define FZ_WPAGES 16
#define FZ_WINQ 4096
#define FZ_TAG (INT64_C(1) << 17)

// Grow-only per-thread scratch for the fused prep (starts/litpos/wb
// in i64, counts/rec_counts/candidates in i32).  Thread-local: the
// Python layer preps independent chains from a thread pool.
typedef struct {
    int64_t* i64; size_t i64cap;
    int32_t* i32; size_t i32cap;
} fz_arena;

static fz_arena* fz_arena_get(void) {
    static thread_local fz_arena a = { nullptr, 0, nullptr, 0 };
    return &a;
}

static int fz_arena_reserve(fz_arena* a, int64_t n64, int64_t n32) {
    if ((size_t)n64 > a->i64cap) {
        size_t cap = a->i64cap ? a->i64cap : 4096;
        while (cap < (size_t)n64) cap *= 2;
        int64_t* p = (int64_t*)realloc(a->i64, cap * sizeof(int64_t));
        if (!p) return -1;
        a->i64 = p; a->i64cap = cap;
    }
    if ((size_t)n32 > a->i32cap) {
        size_t cap = a->i32cap ? a->i32cap : 4096;
        while (cap < (size_t)n32) cap *= 2;
        int32_t* p = (int32_t*)realloc(a->i32, cap * sizeof(int32_t));
        if (!p) return -1;
        a->i32 = p; a->i32cap = cap;
    }
    return 0;
}

static inline int64_t fz_owner(const int32_t* starts, int64_t n, int64_t p) {
    // largest s in [0, n) with starts[s] <= p (clipped to 0)
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (starts[mid] <= p) lo = mid + 1; else hi = mid;
    }
    return lo > 0 ? lo - 1 : 0;
}

// Same, bisecting only [lo0, hi0) — callers pass the substep's seq
// window from so_arr, halving bisect depth and staying cache-hot.
static inline int64_t fz_owner_win(const int32_t* starts, int64_t lo0,
                                   int64_t hi0, int64_t p) {
    int64_t lo = lo0, hi = hi0;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (starts[mid] <= p) lo = mid + 1; else hi = mid;
    }
    return lo > lo0 ? lo - 1 : lo0;
}

#if defined(__AVX2__)
// Left-pack lane indices of set mask bits (branchless candidate
// emission: a predicated `while (cm)` bit loop mispredicts ~every
// vector body on text and cost ~0.2 ms/222K seqs, measured).
static uint8_t fz_pack_idx[256][8];
static const bool fz_pack_idx_init = [] {
    for (int m = 0; m < 256; ++m) {
        int n = 0;
        for (int b = 0; b < 8; ++b)
            if (m & (1 << b)) fz_pack_idx[m][n++] = (uint8_t)b;
        for (; n < 8; ++n) fz_pack_idx[m][n] = 0;
    }
    return true;
}();
#endif

static inline int fz_digits2(int64_t x, int64_t* d0, int64_t* d1,
                             int64_t* carry) {
    int64_t a = ((x + 128) & 255) - 128;
    int64_t x1 = (x - a) >> 8;
    int64_t b = ((x1 + 128) & 255) - 128;
    *carry = (x1 - b) >> 8;
    *d0 = a; *d1 = b;
    return 0;
}

// Shared context for the fused-prep phases (threaded by ranges).
typedef struct {
    const int32_t *ll, *ml, *mo, *ls;
    int64_t S;
    const uint8_t* buf;
    int64_t lit_base, n_win;
    uint8_t* lits;
    int32_t* winq;
    int32_t* scal;
    int32_t* seqrec;
    int32_t* patch;
    int32_t* counts;      // per-substep patch slots used
    int32_t* rec_counts;  // per-substep seq-record slots used
    const int32_t *starts, *litpos;
    const int32_t* wb_arr;
    int32_t* so_arr;      // [n_sub]: seq owning each substep base
    int32_t* hw;          // [n_sub*2] or NULL: per-substep dirty
                          // high-water marks carried WITH the pooled
                          // seqrec/patch buffers (hw[2i]=rec slots,
                          // hw[2i+1]=patch slots written last use)
    int64_t n_sub, n_out;
} fz_ctx;

#define FZ_LLv(c, s) ((s) < (c)->S ? (int64_t)(c)->ll[(s)] : 0)
#define FZ_MOv(c, s) ((s) < (c)->S ? (int64_t)(c)->mo[(s)] : 1)

// phase-2 body for one substep i; s0p/csp are persistent forward-only
// seq pointers owned by the caller (the owner of i*SUB and of
// i*SUB - 1 respectively)
static inline void fz_scal_one(const fz_ctx* c, int64_t i,
                               int64_t* s0p_io, int64_t* csp_io,
                               int32_t* wb_out) {
    int64_t s0p = *s0p_io, csp = *csp_io;
    const int64_t sb = i * FZ_SUB;
    while (c->starts[s0p + 1] <= sb) ++s0p;
    int64_t local0 = sb - c->starts[s0p];
    int64_t l0 = FZ_LLv(c, s0p);
    if (local0 < 0) local0 = 0;
    if (local0 > l0) local0 = l0;
    const int64_t consumed = c->litpos[s0p] + local0;
    int64_t wq = consumed / FZ_WINQ;
    if (wq > c->n_win - 1) wq = c->n_win - 1;
    const int64_t wo = ((consumed - wq * FZ_WINQ) >> 8) & ~(int64_t)7;
    const int64_t wabs = wq * (FZ_WINQ >> 8) + wo;
    const int64_t wbb = wabs << 8;
    const int64_t pb = sb > 0 ? sb - 1 : 0;
    while (c->starts[csp + 1] <= pb) ++csp;
    int64_t u0 = FZ_SUB + (c->litpos[csp] - wbb)
                 - (c->starts[csp] - sb);
    if (u0 < 0) u0 = 0;
    if (u0 > 16383) u0 = 16383;
    const int64_t v0 = (sb - FZ_MOv(c, csp)) & 0xFFFF;
    int64_t b0 = c->starts[csp] + FZ_LLv(c, csp) - sb;
    if (b0 < 0) b0 = 0;
    if (b0 > 8191) b0 = 8191;
    c->winq[i] = (int32_t)wq;
    c->scal[i * 8 + 0] = (int32_t)((i * (FZ_SUB / 256)) % 256);
    c->scal[i * 8 + 1] = (int32_t)wo;
    c->scal[i * 8 + 2] = (int32_t)wabs;
    c->scal[i * 8 + 3] = (int32_t)u0;
    c->scal[i * 8 + 4] = (int32_t)v0;
    c->scal[i * 8 + 5] = (int32_t)b0;
    c->scal[i * 8 + 6] = 0;
    c->scal[i * 8 + 7] = 0;
    wb_out[i] = (int32_t)wbb;
    c->so_arr[i] = (int32_t)s0p;
    *s0p_io = s0p; *csp_io = csp;
}

// phase 2: per-substep scalars for substeps [i_lo, i_hi)
static int32_t fz_scal_range(const fz_ctx* c, int64_t i_lo, int64_t i_hi,
                             int32_t* wb_out) {
    int64_t s0p = fz_owner(c->starts, c->S + 1, i_lo * FZ_SUB);
    int64_t csp = fz_owner(c->starts, c->S + 1,
                           i_lo > 0 ? i_lo * FZ_SUB - 1 : 0);
    for (int64_t i = i_lo; i < i_hi; ++i)
        fz_scal_one(c, i, &s0p, &csp, wb_out);
    return 0;
}

// phase 3: sequence delta records whose start lies in substeps
// [i_lo, i_hi); identical per-substep slot/delta semantics to the
// serial pass because ranges align to substep boundaries.
static int32_t fz_records_range(const fz_ctx* c, int64_t i_lo,
                                int64_t i_hi, int64_t* nrec_out) {
    const int64_t lo_b = i_lo * FZ_SUB, hi_b = i_hi * FZ_SUB;
    int64_t s = fz_owner(c->starts, c->S + 1, lo_b);
    if (c->starts[s] < lo_b) ++s;
    int64_t nrec = 0, cur_sub = -1, slot = 0;
    int64_t prevU = 0, prevV = 0, prevB = 0;
    for (; s < c->S && c->starts[s] < hi_b; ++s) {
        if ((int64_t)c->ll[s] + c->ml[s] <= 0) continue;
        const int64_t st = c->starts[s];
        const int64_t sub_i = st >> FZ_SUB_SHIFT;
        const int64_t pos12 = st - sub_i * FZ_SUB;
        const int64_t U = FZ_SUB + (c->litpos[s] - c->wb_arr[sub_i])
                          - pos12;
        if (U <= 0 || U >= 16384) return -15;
        const int64_t V = (sub_i * FZ_SUB - c->mo[s]) & 0xFFFF;
        int64_t B = pos12 + c->ll[s];
        if (B > 8191) B = 8191;
        int64_t pu, pv, pb2;
        if (sub_i == cur_sub) { pu = prevU; pv = prevV; pb2 = prevB; }
        else {
            cur_sub = sub_i; slot = 0;
            pu = c->scal[sub_i * 8 + 3];
            pv = c->scal[sub_i * 8 + 4];
            pb2 = c->scal[sub_i * 8 + 5];
        }
        if (slot >= FZ_SEQ_MAX) return -10;
        int64_t du0, du1, cu, dv0, dv1, cv, db0, db1, cb;
        fz_digits2(U - pu, &du0, &du1, &cu);
        fz_digits2(V - pv, &dv0, &dv1, &cv);
        fz_digits2(B - pb2, &db0, &db1, &cb);
        if (cu != 0 || cb != 0 || cv < -3 || cv > 3) return -12;
        c->seqrec[(sub_i * 2 + 0) * FZ_SEQ_MAX + slot] = (int32_t)(
            pos12 | ((du0 + 128) << 12) | ((du1 + 128) << 20)
            | ((cv + 4) << 28));
        c->seqrec[(sub_i * 2 + 1) * FZ_SEQ_MAX + slot] = (int32_t)(
            (dv0 + 128) | ((dv1 + 128) << 8) | ((db0 + 128) << 16)
            | ((db1 + 128) << 24));
        ++slot; ++nrec;
        c->rec_counts[sub_i] = (int32_t)slot;
        prevU = U; prevV = V; prevB = B;
    }
    *nrec_out = nrec;
    return 0;
}

// phase 5: zero the unwritten slot tails (callers hand DIRTY pooled
// buffers; zero-filling multi-MB arrays per request costs more than
// the prep's own arithmetic).  With hw marks the memsets stop at the
// buffer's PREVIOUS per-substep write counts instead of the slot
// capacity, so a steady-state pool (same workload shape) zeroes
// almost nothing; hw is then updated to this request's counts.
static void fz_zero_tails(const fz_ctx* c, int64_t i_lo, int64_t i_hi) {
    for (int64_t i = i_lo; i < i_hi; ++i) {
        const int64_t rc = c->rec_counts[i];
        const int64_t pc = c->counts[i];
        int64_t rhi = FZ_SEQ_MAX, phi = FZ_PATCH_MAX;
        if (c->hw) {
            rhi = c->hw[2 * i] > rc ? c->hw[2 * i] : rc;
            phi = c->hw[2 * i + 1] > pc ? c->hw[2 * i + 1] : pc;
            // the patch fill's 8-lane stores overshoot up to 7 slots
            // past the substep's final count (last vector block
            // starts at a slot <= pc-1) — always clear that margin
            // even when hw says the buffer was clean there
            int64_t pad = pc + 7;
            if (pad > FZ_PATCH_MAX) pad = FZ_PATCH_MAX;
            if (pad > phi) phi = pad;
        }
        memset(c->seqrec + (i * 2 + 0) * FZ_SEQ_MAX + rc, 0,
               (size_t)(rhi - rc) * 4);
        memset(c->seqrec + (i * 2 + 1) * FZ_SEQ_MAX + rc, 0,
               (size_t)(rhi - rc) * 4);
        memset(c->patch + i * FZ_PATCH_MAX + pc, 0,
               (size_t)(phi - pc) * 4);
        if (c->hw) {
            c->hw[2 * i] = (int32_t)rc;
            c->hw[2 * i + 1] = (int32_t)pc;
        }
    }
}

// phase-4 body for one patch-candidate seq s (ml>0 && mo<SUB):
// emit patches for its match pieces whose target substep base lies in
// [lo_b, hi_b).  Returns 0 or a negative overflow code.
static inline int32_t fz_patch_seq(const fz_ctx* c, int64_t s,
                                   int64_t lo_b, int64_t hi_b,
                                   int64_t* npat_io) {
    {
        const int64_t moff = c->mo[s];
        const int64_t mstart = c->starts[s] + c->ll[s];
        const int64_t mend = c->starts[s + 1];
        int64_t cur_lo = mstart;
        int pieces = 0;
        while (cur_lo < mend) {
            if (++pieces > 64) return -16;
            const int64_t si = cur_lo >> FZ_SUB_SHIFT;
            const int64_t sb = si * FZ_SUB;
            int64_t pe = sb + FZ_SUB;
            if (mend < pe) pe = mend;
            if (sb < lo_b || sb >= hi_b) { cur_lo = pe; continue; }
            int64_t plo = sb + moff;
            if (cur_lo > plo) plo = cur_lo;
            if (plo >= pe) { cur_lo = pe; continue; }
            const int64_t w_lo = c->so_arr[si];
            const int64_t w_hi = si + 1 < c->n_sub
                ? (int64_t)c->so_arr[si + 1] + 1 : c->S + 1;
            int64_t hint = fz_owner_win(c->starts, w_lo, w_hi,
                                        plo - moff);
            int64_t p = plo;
            while (p < pe) {
                // resolve byte p, tracking how many FOLLOWING bytes
                // share the same chain structure (every hop stays
                // inside its segment): those resolve to code, code+1,
                // ... and emit in one tight loop — per-byte chain
                // walks cost ~45 ns, runs amortize them on text
                int64_t p2 = p, code = 0;
                int64_t rem = pe - p;
                int depth = 0;
                for (;;) {
                    if (++depth > 64) return -14;
                    int64_t s2;
                    if (depth == 1) {
                        s2 = s;
                    } else if (depth == 2) {
                        while (c->starts[hint + 1] <= p2) ++hint;
                        s2 = hint;
                    } else {
                        s2 = fz_owner_win(c->starts, w_lo, w_hi, p2);
                    }
                    const int64_t local = p2 - c->starts[s2];
                    const int64_t llv = FZ_LLv(c, s2);
                    if (local < llv) {
                        // literal terminal: valid while inside this
                        // literal run and the window
                        const int64_t lit_rel =
                            c->litpos[s2] + local - c->wb_arr[si];
                        if (lit_rel < 0 || lit_rel >= FZ_WPAGES * 256)
                            return -13;
                        if (llv - local < rem) rem = llv - local;
                        if (FZ_WPAGES * 256 - lit_rel < rem)
                            rem = FZ_WPAGES * 256 - lit_rel;
                        code = 65536 + lit_rel;
                        break;
                    }
                    const int64_t hop = p2 - FZ_MOv(c, s2);
                    if (hop < sb) {
                        // ring terminal: valid while still before the
                        // substep, on the same 64 Ki page cycle, AND
                        // inside this sequence (past its end the
                        // offset changes)
                        if (sb - hop < rem) rem = sb - hop;
                        const int64_t low = hop & 0xFFFF;
                        if (65536 - low < rem) rem = 65536 - low;
                        const int64_t seg_end = c->starts[s2 + 1];
                        if (seg_end - p2 < rem) rem = seg_end - p2;
                        code = low;
                        break;
                    }
                    // intermediate hop: the run stays valid while the
                    // hop position remains inside this sequence
                    {
                        const int64_t seg_end = c->starts[s2 + 1];
                        if (seg_end - p2 < rem) rem = seg_end - p2;
                    }
                    p2 = hop;
                }
                if (rem < 1) rem = 1;
                int64_t slot2 = c->counts[si];
                if (slot2 + rem > FZ_PATCH_MAX) return -11;
                c->counts[si] = (int32_t)(slot2 + rem);
                int32_t* dst = c->patch + si * FZ_PATCH_MAX + slot2;
                const int64_t base = ((p - sb) << 18) | code | FZ_TAG;
#if defined(__AVX2__)
                // 8-lane affine fill (the scalar data-dependent loop
                // cost ~0.4 ms/28K patch bytes on t1111k, measured).
                // May overshoot up to 7 slots past the run end: later
                // runs in the substep overwrite, and fz_zero_tails
                // clears the final <=7-slot margin past the substep's
                // count (see its phi bound).
                if (slot2 + ((rem + 7) & ~(int64_t)7) <= FZ_PATCH_MAX) {
                    const int32_t STEP = (1 << 18) | 1;
                    __m256i v = _mm256_add_epi32(
                        _mm256_set1_epi32((int32_t)base),
                        _mm256_mullo_epi32(
                            _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7),
                            _mm256_set1_epi32(STEP)));
                    const __m256i step8 = _mm256_set1_epi32(8 * STEP);
                    for (int64_t k = 0; k < rem; k += 8) {
                        _mm256_storeu_si256((__m256i*)(dst + k), v);
                        v = _mm256_add_epi32(v, step8);
                    }
                } else
#endif
                for (int64_t k = 0; k < rem; ++k)
                    dst[k] = (int32_t)(base + k * ((1 << 18) | 1));
                *npat_io += rem;
                p += rem;
            }
            cur_lo = pe;
        }
    }
    return 0;
}

// phase 4: in-substep patches whose TARGET substep lies in
// [i_lo, i_hi) (one writer per substep: no slot races, serial order).
static int32_t fz_patch_range(const fz_ctx* c, int64_t i_lo,
                              int64_t i_hi, int64_t* npat_out) {
    const int64_t lo_b = i_lo * FZ_SUB, hi_b = i_hi * FZ_SUB;
    int64_t npat = 0;
    int64_t s = fz_owner(c->starts, c->S + 1, lo_b);
    for (; s < c->S && c->starts[s] < hi_b; ++s) {
        if (c->ml[s] <= 0 || c->mo[s] >= FZ_SUB) continue;
        int32_t st = fz_patch_seq(c, s, lo_b, hi_b, &npat);
        if (st) return st;
    }
    *npat_out = npat;
    return 0;
}

// Fused serial pass: ONE scan over the sequences emits per-substep
// scalars (triggered at substep boundaries), sequence records, and a
// compact list of patch-candidate seqs; patches then walk only the
// candidates.  Output-identical to fz_scal_range + fz_records_range +
// fz_patch_range over the full range (same per-substep slot order),
// and error precedence matches too: all records errors precede any
// patch error, lowest position first.  The separate range functions
// remain for the threaded path; a differential test pins the two.
static int32_t fz_fused_serial(const fz_ctx* c, int32_t* wb_out,
                               int64_t* nrec_out, int64_t* npat_out,
                               int32_t* cand, int64_t* ncand_out) {
    const int64_t S = c->S, n_sub = c->n_sub;
    int64_t next_sub = 0, s0p = 0, csp = 0;
    int64_t cur_sub = -1, slot = 0;
    int64_t prevU = 0, prevV = 0, prevB = 0;
    int64_t nrec = 0, ncand = 0;
    for (int64_t s = 0; s < S; ) {
#if defined(__AVX2__)
        // ---- 8-wide vector path ----
        // Preconditions: 8 more seqs, all starting in ONE substep,
        // none zero-length, record budget has room.  Byte-identical
        // to the scalar body: same records, same slot order, same
        // candidate order; any range/digit violation bails to the
        // scalar body (uncommitted), which reproduces the exact
        // error code at the right sequence.  Boundary scal emission
        // moves to block entry (base <= starts[s]) — equivalent to
        // the scalar trigger because a seq whose span crosses a
        // boundary forces its successor into a later substep, which
        // fails the one-substep precondition and goes scalar.
        if (s + 8 <= S) {
            const int32_t* stp = c->starts + s;
            const int64_t st0 = stp[0];
            const int64_t sub0 = st0 >> FZ_SUB_SHIFT;
            if ((stp[7] >> FZ_SUB_SHIFT) == sub0) {
                while (next_sub < n_sub && next_sub * FZ_SUB <= st0) {
                    fz_scal_one(c, next_sub, &s0p, &csp, wb_out);
                    ++next_sub;
                }
                __m256i stv = _mm256_loadu_si256((const __m256i*)stp);
                __m256i stn = _mm256_loadu_si256((const __m256i*)(stp + 1));
                int nz = _mm256_movemask_ps(_mm256_castsi256_ps(
                    _mm256_cmpgt_epi32(stn, stv)));
                int64_t slot_v = (sub0 == cur_sub) ? slot : 0;
                if (nz == 0xFF && slot_v + 8 <= FZ_SEQ_MAX) {
                    int64_t pu, pv, pb2;
                    if (sub0 == cur_sub) {
                        pu = prevU; pv = prevV; pb2 = prevB;
                    } else {
                        pu = c->scal[sub0 * 8 + 3];
                        pv = c->scal[sub0 * 8 + 4];
                        pb2 = c->scal[sub0 * 8 + 5];
                    }
                    const __m256i k255 = _mm256_set1_epi32(255);
                    const __m256i k128 = _mm256_set1_epi32(128);
                    const __m256i pos12v = _mm256_and_si256(
                        stv, _mm256_set1_epi32(FZ_SUB - 1));
                    const __m256i lpv = _mm256_loadu_si256(
                        (const __m256i*)(c->litpos + s));
                    const __m256i llv = _mm256_loadu_si256(
                        (const __m256i*)(c->ll + s));
                    const __m256i mov = _mm256_loadu_si256(
                        (const __m256i*)(c->mo + s));
                    const int32_t wb0 = c->wb_arr[sub0];
                    // U = (SUB - wb) + litpos - pos12
                    __m256i Uv = _mm256_add_epi32(
                        _mm256_set1_epi32((int32_t)(FZ_SUB - wb0)),
                        _mm256_sub_epi32(lpv, pos12v));
                    // V = (sub_base - mo) & 0xFFFF
                    __m256i Vv = _mm256_and_si256(
                        _mm256_sub_epi32(
                            _mm256_set1_epi32(
                                (int32_t)(sub0 * FZ_SUB)), mov),
                        _mm256_set1_epi32(0xFFFF));
                    // B = min(pos12 + ll, 8191)
                    __m256i Bv = _mm256_min_epi32(
                        _mm256_add_epi32(pos12v, llv),
                        _mm256_set1_epi32(8191));
                    // previous-record vectors (rotate + carry lane 0)
                    const __m256i rot = _mm256_setr_epi32(
                        7, 0, 1, 2, 3, 4, 5, 6);
                    __m256i Upr = _mm256_blend_epi32(
                        _mm256_permutevar8x32_epi32(Uv, rot),
                        _mm256_set1_epi32((int32_t)pu), 1);
                    __m256i Vpr = _mm256_blend_epi32(
                        _mm256_permutevar8x32_epi32(Vv, rot),
                        _mm256_set1_epi32((int32_t)pv), 1);
                    __m256i Bpr = _mm256_blend_epi32(
                        _mm256_permutevar8x32_epi32(Bv, rot),
                        _mm256_set1_epi32((int32_t)pb2), 1);
                    __m256i dU = _mm256_sub_epi32(Uv, Upr);
                    __m256i dV = _mm256_sub_epi32(Vv, Vpr);
                    __m256i dB = _mm256_sub_epi32(Bv, Bpr);
                    // balanced base-256 digits
                    #define FZ_DIG(x, d0, x1, d1, cc)                   \
                        __m256i d0 = _mm256_sub_epi32(                  \
                            _mm256_and_si256(                           \
                                _mm256_add_epi32(x, k128), k255), k128);\
                        __m256i x1 = _mm256_srai_epi32(                 \
                            _mm256_sub_epi32(x, d0), 8);                \
                        __m256i d1 = _mm256_sub_epi32(                  \
                            _mm256_and_si256(                           \
                                _mm256_add_epi32(x1, k128), k255),      \
                            k128);                                      \
                        __m256i cc = _mm256_srai_epi32(                 \
                            _mm256_sub_epi32(x1, d1), 8)
                    FZ_DIG(dU, du0, xu1, du1, cu);
                    FZ_DIG(dV, dv0, xv1, dv1, cv);
                    FZ_DIG(dB, db0, xb1, db1, cb);
                    #undef FZ_DIG
                    // violations: U<=0, U>=16384, cu!=0, cb!=0, |cv|>3
                    __m256i zero = _mm256_setzero_si256();
                    __m256i bad = _mm256_or_si256(
                        _mm256_cmpgt_epi32(_mm256_set1_epi32(1), Uv),
                        _mm256_cmpgt_epi32(Uv,
                                           _mm256_set1_epi32(16383)));
                    bad = _mm256_or_si256(bad, _mm256_xor_si256(
                        _mm256_cmpeq_epi32(cu, zero),
                        _mm256_set1_epi32(-1)));
                    bad = _mm256_or_si256(bad, _mm256_xor_si256(
                        _mm256_cmpeq_epi32(cb, zero),
                        _mm256_set1_epi32(-1)));
                    bad = _mm256_or_si256(bad, _mm256_cmpgt_epi32(
                        _mm256_abs_epi32(cv), _mm256_set1_epi32(3)));
                    if (_mm256_testz_si256(bad, bad)) {
                        __m256i rec0 = _mm256_or_si256(
                            _mm256_or_si256(
                                pos12v,
                                _mm256_slli_epi32(
                                    _mm256_add_epi32(du0, k128), 12)),
                            _mm256_or_si256(
                                _mm256_slli_epi32(
                                    _mm256_add_epi32(du1, k128), 20),
                                _mm256_slli_epi32(
                                    _mm256_add_epi32(
                                        cv, _mm256_set1_epi32(4)),
                                    28)));
                        __m256i rec1 = _mm256_or_si256(
                            _mm256_or_si256(
                                _mm256_add_epi32(dv0, k128),
                                _mm256_slli_epi32(
                                    _mm256_add_epi32(dv1, k128), 8)),
                            _mm256_or_si256(
                                _mm256_slli_epi32(
                                    _mm256_add_epi32(db0, k128), 16),
                                _mm256_slli_epi32(
                                    _mm256_add_epi32(db1, k128), 24)));
                        int32_t* p0 = c->seqrec
                            + (sub0 * 2 + 0) * FZ_SEQ_MAX + slot_v;
                        int32_t* p1 = c->seqrec
                            + (sub0 * 2 + 1) * FZ_SEQ_MAX + slot_v;
                        _mm256_storeu_si256((__m256i*)p0, rec0);
                        _mm256_storeu_si256((__m256i*)p1, rec1);
                        cur_sub = sub0;
                        slot = slot_v + 8;
                        nrec += 8;
                        c->rec_counts[sub0] = (int32_t)slot;
                        prevU = _mm256_extract_epi32(Uv, 7);
                        prevV = _mm256_extract_epi32(Vv, 7);
                        prevB = _mm256_extract_epi32(Bv, 7);
                        // Candidate = in-substep match (mo < SUB) that
                        // can actually emit a patch: its first-piece
                        // window [sb_m + mo, mend) is nonempty, or it
                        // crosses a substep boundary (conservative
                        // keep; fz_patch_seq re-derives windows, so a
                        // kept candidate that emits nothing is only a
                        // few ns).  Emission is a branchless left-pack
                        // of the mask lanes.
                        const __m256i mlv = _mm256_loadu_si256(
                            (const __m256i*)(c->ml + s));
                        const __m256i mstartv =
                            _mm256_add_epi32(stv, llv);
                        const __m256i sbmv = _mm256_andnot_si256(
                            _mm256_set1_epi32(FZ_SUB - 1), mstartv);
                        const __m256i crossv = _mm256_cmpgt_epi32(
                            _mm256_srai_epi32(
                                _mm256_sub_epi32(
                                    stn, _mm256_set1_epi32(1)),
                                FZ_SUB_SHIFT),
                            _mm256_srai_epi32(mstartv, FZ_SUB_SHIFT));
                        const __m256i inpv = _mm256_cmpgt_epi32(
                            stn, _mm256_add_epi32(sbmv, mov));
                        const __m256i candm = _mm256_and_si256(
                            _mm256_and_si256(
                                _mm256_cmpgt_epi32(mlv, zero),
                                _mm256_cmpgt_epi32(
                                    _mm256_set1_epi32(FZ_SUB), mov)),
                            _mm256_or_si256(crossv, inpv));
                        const int cm = _mm256_movemask_ps(
                            _mm256_castsi256_ps(candm));
                        const __m256i idxv = _mm256_cvtepu8_epi32(
                            _mm_loadl_epi64(
                                (const __m128i*)fz_pack_idx[cm]));
                        _mm256_storeu_si256(
                            (__m256i*)(cand + ncand),
                            _mm256_add_epi32(
                                _mm256_set1_epi32((int32_t)s), idxv));
                        ncand += __builtin_popcount((unsigned)cm);
                        s += 8;
                        continue;
                    }
                }
            }
        }
#endif
        const int64_t st = c->starts[s];
        const int64_t end = c->starts[s + 1];
        if (end <= st) { ++s; continue; }
        while (next_sub < n_sub && next_sub * FZ_SUB < end) {
            fz_scal_one(c, next_sub, &s0p, &csp, wb_out);
            ++next_sub;
        }
        // ---- record (phase-3 body) ----
        const int64_t sub_i = st >> FZ_SUB_SHIFT;
        const int64_t pos12 = st - sub_i * FZ_SUB;
        const int64_t U = FZ_SUB + (c->litpos[s] - c->wb_arr[sub_i])
                          - pos12;
        if (U <= 0 || U >= 16384) return -15;
        const int64_t V = (sub_i * FZ_SUB - c->mo[s]) & 0xFFFF;
        int64_t B = pos12 + c->ll[s];
        if (B > 8191) B = 8191;
        int64_t pu, pv, pb2;
        if (sub_i == cur_sub) { pu = prevU; pv = prevV; pb2 = prevB; }
        else {
            cur_sub = sub_i; slot = 0;
            pu = c->scal[sub_i * 8 + 3];
            pv = c->scal[sub_i * 8 + 4];
            pb2 = c->scal[sub_i * 8 + 5];
        }
        if (slot >= FZ_SEQ_MAX) return -10;
        int64_t du0, du1, cu, dv0, dv1, cv, db0, db1, cb;
        fz_digits2(U - pu, &du0, &du1, &cu);
        fz_digits2(V - pv, &dv0, &dv1, &cv);
        fz_digits2(B - pb2, &db0, &db1, &cb);
        if (cu != 0 || cb != 0 || cv < -3 || cv > 3) return -12;
        c->seqrec[(sub_i * 2 + 0) * FZ_SEQ_MAX + slot] = (int32_t)(
            pos12 | ((du0 + 128) << 12) | ((du1 + 128) << 20)
            | ((cv + 4) << 28));
        c->seqrec[(sub_i * 2 + 1) * FZ_SEQ_MAX + slot] = (int32_t)(
            (dv0 + 128) | ((dv1 + 128) << 8) | ((db0 + 128) << 16)
            | ((db1 + 128) << 24));
        ++slot; ++nrec;
        c->rec_counts[sub_i] = (int32_t)slot;
        prevU = U; prevV = V; prevB = B;
        if (c->ml[s] > 0 && c->mo[s] < FZ_SUB) {
            // same can-emit prefilter as the vector path
            const int64_t mstart = st + c->ll[s];
            const int64_t sbm = mstart & ~(int64_t)(FZ_SUB - 1);
            if (((end - 1) >> FZ_SUB_SHIFT) > (mstart >> FZ_SUB_SHIFT)
                || end > sbm + c->mo[s])
                cand[ncand++] = (int32_t)s;
        }
        ++s;
    }
    // trailing substeps with no seq start past them (match spans)
    while (next_sub < n_sub) {
        fz_scal_one(c, next_sub, &s0p, &csp, wb_out);
        ++next_sub;
    }
    *nrec_out = nrec;
    *ncand_out = ncand;
    // ---- patches over candidates only ----
    const int64_t tb2 = getenv("LZ4TPU_PREP_PROFILE") ? fz_now_ns() : 0;
    int64_t npat = 0;
    const int64_t hi_b = n_sub * FZ_SUB;
    for (int64_t k = 0; k < ncand; ++k) {
        int32_t st2 = fz_patch_seq(c, cand[k], 0, hi_b, &npat);
        if (st2) return st2;
    }
    if (tb2)
        fprintf(stderr, "  fused: B1 scan+rec ends, B2 patches %.3f ms "
                "(cand %lld)\n",
                (fz_now_ns() - tb2) * 1e-6, (long long)ncand);
    *npat_out = npat;
    return 0;
}

// Returns 0 on success; negative overflow codes:
// -10 seq-record budget, -11 patch budget, -12 digit range,
// -13 patch literal outside window, -14 patch chain depth,
// -15 literal affine constant range, -16 match spans cross >64 substeps
// n_threads > 1 splits phases 2-4 by substep ranges (bit-identical to
// the serial pass: ranges align to substep boundaries and every
// substep has exactly one writer).
// Post-phase-1 body shared by lz4tpu_prep_fused (which computes
// starts/litpos/lits itself) and lz4tpu_prep_fused_pre (which takes
// them precomputed from lz4tpu_scan_block_full).  `scratch_off` is
// the fz_arena i32 offset already consumed by the caller.
static int32_t fz_prep_body(
    const int32_t* ll, const int32_t* ml, const int32_t* mo,
    const int32_t* ls, int64_t S,
    const uint8_t* buf,
    int64_t lit_base, int64_t n_win,
    const int32_t* starts, const int32_t* litpos,
    uint8_t* lits, int64_t n_out,
    int32_t* winq, int32_t* scal, int32_t* seqrec, int32_t* patch,
    int32_t* hw,
    int64_t* out_counts, int32_t n_threads,
    int64_t scratch_off, int prof, int64_t tp0) {
    fz_arena* A = fz_arena_get();
    const int64_t n_sub = (n_out + FZ_SUB - 1) / FZ_SUB;
    const int64_t nsub1 = n_sub ? n_sub : 1;
    // +8: the vector candidate left-pack stores a full 8-lane vector
    // at cand+ncand and advances by popcount only
    if (fz_arena_reserve(A, 0, scratch_off + 4 * nsub1 + S + 9))
        return -99;
    int32_t* wb_arr = A->i32 + scratch_off;
    int32_t* counts = A->i32 + scratch_off + nsub1;
    int32_t* rec_counts = A->i32 + scratch_off + 2 * nsub1;
    int32_t* so_arr = A->i32 + scratch_off + 3 * nsub1;
    int32_t* cand = A->i32 + scratch_off + 4 * nsub1;
    memset(counts, 0, (size_t)nsub1 * 4);
    memset(rec_counts, 0, (size_t)nsub1 * 4);
    fz_ctx c = { ll, ml, mo, ls, S, buf, lit_base, n_win, lits, winq,
                 scal, seqrec, patch, counts, rec_counts, starts,
                 litpos, wb_arr, so_arr, hw, n_sub, n_out };
    int32_t ret = 0;
    int rec_done = 0;
    int64_t nrec = 0, npat = 0, ncand = 0;
    if (prof) {
        int64_t t1 = fz_now_ns();
        ret = fz_fused_serial(&c, wb_arr, &nrec, &npat, cand, &ncand);
        int64_t t2 = fz_now_ns();
        if (ret == 0) fz_zero_tails(&c, 0, n_sub);
        int64_t t3 = fz_now_ns();
        fprintf(stderr,
                "prep_fused S=%lld n_sub=%lld cand=%lld: lits+starts "
                "%.3f ms, fused scal+rec+patch %.3f, tails %.3f\n",
                (long long)S, (long long)n_sub, (long long)ncand,
                (t1 - tp0) * 1e-6, (t2 - t1) * 1e-6, (t3 - t2) * 1e-6);
    } else if (n_threads <= 1 || n_sub < 4 * (int64_t)n_threads) {
        ret = fz_fused_serial(&c, wb_arr, &nrec, &npat, cand, &ncand);
        if (ret == 0) fz_zero_tails(&c, 0, n_sub);
    } else {
        const int64_t T = n_threads;
        const int64_t per = (n_sub + T - 1) / T;
        std::vector<int32_t> st2(T, 0), st3(T, 0), st4(T, 0);
        std::vector<int64_t> nr(T, 0), np2(T, 0);
        {
            std::vector<std::thread> ths;
            for (int64_t t = 0; t < T; ++t) {
                int64_t a = t * per, b = a + per;
                if (b > n_sub) b = n_sub;
                if (a >= b) continue;
                ths.emplace_back([&, t, a, b] {
                    st2[t] = fz_scal_range(&c, a, b, wb_arr);
                });
            }
            for (auto& th : ths) th.join();
        }
        // first failing range wins so threaded runs report the same
        // overflow reason as the serial pass (lowest substep range)
        for (int64_t t = 0; t < T; ++t)
            if (st2[t] && ret == 0) ret = st2[t];
        if (ret == 0) {
            std::vector<std::thread> ths;
            for (int64_t t = 0; t < T; ++t) {
                int64_t a = t * per, b = a + per;
                if (b > n_sub) b = n_sub;
                if (a >= b) continue;
                ths.emplace_back([&, t, a, b] {
                    st3[t] = fz_records_range(&c, a, b, &nr[t]);
                    if (st3[t] == 0)
                        st4[t] = fz_patch_range(&c, a, b, &np2[t]);
                    if (st3[t] == 0 && st4[t] == 0)
                        fz_zero_tails(&c, a, b);
                });
            }
            for (auto& th : ths) th.join();
            // match the serial pass's reason: all records errors
            // (phase 3) precede any patch error (phase 4), lowest
            // substep range first within a phase
            for (int64_t t = 0; t < T; ++t)
                if (st3[t] && ret == 0) ret = st3[t];
            for (int64_t t = 0; t < T; ++t)
                if (st4[t] && ret == 0) ret = st4[t];
            for (int64_t t = 0; t < T; ++t) {
                nrec += nr[t];
                npat += np2[t];
            }
            if (ret == 0 && fz_counters_enabled()) {
                int64_t rows[4 * 64];
                int64_t n = 0;
                for (int64_t t = 0; t < T && n < 64; ++t) {
                    int64_t a = t * per, b = a + per;
                    if (b > n_sub) b = n_sub;
                    if (a >= b) continue;
                    rows[4 * n] = a;
                    rows[4 * n + 1] = b;
                    rows[4 * n + 2] = nr[t];
                    rows[4 * n + 3] = np2[t];
                    ++n;
                }
                fz_record_ranges(rows, n);
                rec_done = 1;
            }
        }
    }
    if (ret == 0 && fz_counters_enabled() && !rec_done) {
        int64_t row[4] = { 0, n_sub, nrec, npat };
        fz_record_ranges(row, 1);
    }
    if (ret == 0) {
        // window-reload flags (scal[8i+6]): the kernel skips the
        // per-substep literal-window VMEM refresh when the window is
        // unchanged (substep 0 and every (winq, wabs) transition
        // reload; chain starts are substep 0 of their own prep call)
        int32_t max_rc = 0, max_pc = 0;
        for (int64_t i = 0; i < n_sub; ++i) {
            if (i == 0 || winq[i] != winq[i - 1]
                    || scal[i * 8 + 2] != scal[(i - 1) * 8 + 2])
                scal[i * 8 + 6] = 1;
            if (rec_counts[i] > max_rc) max_rc = rec_counts[i];
            if (counts[i] > max_pc) max_pc = counts[i];
        }
        out_counts[0] = nrec;
        out_counts[1] = npat;
        out_counts[2] = max_rc;
        out_counts[3] = max_pc;
    } else if (hw) {
        // An aborted pass (overflow) wrote live slots but never ran
        // fz_zero_tails, so the buffer's dirt is no longer described
        // by hw: mark every substep at capacity so the pool's next
        // user zeroes conservatively.  (Writes never exceed the
        // running counts, but capacity is the simple safe bound.)
        for (int64_t i = 0; i < n_sub; ++i) {
            hw[2 * i] = FZ_SEQ_MAX;
            hw[2 * i + 1] = FZ_PATCH_MAX;
        }
    }
    return ret;
}

// Prep from precomputed scan_block_full outputs: starts/litpos carry
// the S/S+1 sentinels, literals are already extracted — phase 1 is
// skipped entirely (the single-block request fast path).
int32_t lz4tpu_prep_fused_pre(
    const int32_t* ll, const int32_t* ml, const int32_t* mo,
    const int32_t* ls, int64_t S,
    const uint8_t* buf,
    int64_t n_win,
    const int32_t* starts,   // [S + 2] with sentinels
    const int32_t* litpos,   // [S + 2] with sentinels
    uint8_t* lits, int64_t n_out,
    int32_t* winq, int32_t* scal, int32_t* seqrec, int32_t* patch,
    int32_t* hw,
    int64_t* out_counts, int32_t n_threads) {
    const int prof = getenv("LZ4TPU_PREP_PROFILE") != NULL;
    return fz_prep_body(ll, ml, mo, ls, S, buf, 0, n_win,
                        starts, litpos, lits, n_out,
                        winq, scal, seqrec, patch, hw, out_counts,
                        n_threads, 0, prof, prof ? fz_now_ns() : 0);
}

int32_t lz4tpu_prep_fused(
    const int32_t* ll, const int32_t* ml, const int32_t* mo,
    const int32_t* ls, int64_t S,
    const uint8_t* buf, int64_t buf_len,
    int64_t lit_base, int64_t n_win,
    uint8_t* lits,           // [chain literal bytes]
    int64_t lit_cap,         // writable bytes at lits
    int32_t* winq,           // [n_sub]
    int32_t* scal,           // [n_sub * 8]
    int32_t* seqrec,         // [n_sub * 2 * FZ_SEQ_MAX]
    int32_t* patch,          // [n_sub * FZ_PATCH_MAX]
    int32_t* hw,             // [n_sub * 2] pool high-water or NULL
    int64_t* out_counts,     // [2]: n_seq_recs, n_patches
    int32_t n_threads) {
    const int prof = getenv("LZ4TPU_PREP_PROFILE") != NULL;
    int64_t tp0 = prof ? fz_now_ns() : 0;
    // grow-only thread-local scratch: fresh multi-MB mallocs cost up
    // to ~2 ms in first-touch page faults per request (measured).
    // Positions are int32 (the batched pipeline's 2 GiB capacity
    // invariant bounds every position below 2**31; defensively checked
    // after the cumsum) — halves the bisects' cache footprint.
    fz_arena* A = fz_arena_get();
    const int64_t ns1 = 1 > (S + 2) ? 1 : (S + 2);
    if (fz_arena_reserve(A, 0, 2 * ns1)) return -99;
    int32_t* starts = A->i32;
    int32_t* litpos = A->i32 + ns1;
    int64_t out = 0, lp = lit_base;
    int64_t s1 = 0;
#if defined(__AVX2__)
    {
        // 8-wide exclusive prefix sums of (ll+ml) -> starts and
        // ll -> litpos: in-vector log-shift adds plus a running carry
        __m256i accs = _mm256_set1_epi32(0);
        __m256i accl = _mm256_set1_epi32((int32_t)lit_base);
        for (; s1 + 8 <= S; s1 += 8) {
            __m256i a = _mm256_loadu_si256((const __m256i*)(ll + s1));
            __m256i b = _mm256_loadu_si256((const __m256i*)(ml + s1));
            __m256i t = _mm256_add_epi32(a, b);
            // inclusive prefix within the 8 lanes
            #define FZ_PFX(v)                                            \
                v = _mm256_add_epi32(v, _mm256_slli_si256(v, 4));        \
                v = _mm256_add_epi32(v, _mm256_slli_si256(v, 8));        \
                v = _mm256_add_epi32(                                    \
                    v, _mm256_permute2x128_si256(                        \
                        _mm256_shuffle_epi32(v, 0xFF),                   \
                        _mm256_setzero_si256(), 0x03))
            FZ_PFX(t);
            FZ_PFX(a);
            #undef FZ_PFX
            // exclusive = carry + inclusive shifted right one lane
            const __m256i rot = _mm256_setr_epi32(7, 0, 1, 2, 3, 4, 5, 6);
            __m256i te = _mm256_blend_epi32(
                _mm256_permutevar8x32_epi32(t, rot),
                _mm256_setzero_si256(), 1);
            __m256i ae = _mm256_blend_epi32(
                _mm256_permutevar8x32_epi32(a, rot),
                _mm256_setzero_si256(), 1);
            _mm256_storeu_si256((__m256i*)(starts + s1),
                                _mm256_add_epi32(accs, te));
            _mm256_storeu_si256((__m256i*)(litpos + s1),
                                _mm256_add_epi32(accl, ae));
            accs = _mm256_add_epi32(
                accs, _mm256_permutevar8x32_epi32(
                    t, _mm256_set1_epi32(7)));
            accl = _mm256_add_epi32(
                accl, _mm256_permutevar8x32_epi32(
                    a, _mm256_set1_epi32(7)));
        }
        out = (uint32_t)_mm256_extract_epi32(accs, 0);
        lp = (uint32_t)_mm256_extract_epi32(accl, 0);
    }
#endif
    for (int64_t s = s1; s < S; ++s) {
        starts[s] = (int32_t)out; litpos[s] = (int32_t)lp;
        out += ll[s] + ml[s];
        lp += ll[s];
    }
    const int64_t n_out = out;
    // literal extraction: branchless bounded 16-byte wild copies (cf.
    // the reference's Write_Output wild copies, lz4ada.adb:807-817):
    // every literal position is owned by exactly one run and runs
    // write in order, so a later run overwrites our spill — zero-
    // length runs included (their copy lands on the next run's bytes)
    for (int64_t s = 0; s < S; ++s) {
        const int64_t n = ll[s];
        const int64_t rel = litpos[s] - lit_base;
        uint8_t* d = lits + rel;
        const uint8_t* q = buf + ls[s];
        if (n <= 16 && ls[s] >= 0 && ls[s] + 16 <= buf_len
            && rel + 16 <= lit_cap) {
            memcpy(d, q, 16);
        } else if (n) {
            memcpy(d, q, (size_t)n);
        }
    }
    if (out >= INT64_C(0x7FFFFFF0) || lp >= INT64_C(0x7FFFFFF0))
        return -98;   // beyond int32 positions (pipeline never sends this)
    starts[S] = (int32_t)n_out; starts[S + 1] = INT32_C(0x7FFFFFFF);
    litpos[S] = (int32_t)lp; litpos[S + 1] = (int32_t)lp;
    const int64_t n_sub = (n_out + FZ_SUB - 1) / FZ_SUB;
    const int64_t nsub1 = n_sub ? n_sub : 1;
    // Reserve the body's scratch HERE so fz_prep_body's own reserve
    // is a guaranteed no-op (a realloc there would move the arena
    // under the starts/litpos pointers we pass in).
    if (fz_arena_reserve(A, 0, 2 * ns1 + 4 * nsub1 + S + 9))
        return -99;
    starts = A->i32;             // reserve may have moved the arena
    litpos = A->i32 + ns1;
    return fz_prep_body(ll, ml, mo, ls, S, buf, lit_base, n_win,
                        starts, litpos, lits, n_out,
                        winq, scal, seqrec, patch, hw, out_counts,
                        n_threads, 2 * ns1, prof, tp0);
}


// ---------------------------------------------------------------------------
// Boundary-window resolver (lz4tpu/spans.py): materialize chain output
// bytes [B - W, B) by provenance chain-following through the sequence
// table — the host side of span-parallel decode of one monolithic
// dependent-block chain (the reference's serial history-ring regime,
// lib/lz4ada.adb:845-904, re-cut at span boundaries).
//
// Work is O(W + walks), NOT O(chain output): positions resolve in
// ascending order so in-window back-references copy from already-
// resolved bytes (an LZ4-style overlapping copy); only references
// escaping the window walk their chain, one run-amortized walk per
// stable-structure run (the fz_patch_seq trick), with the overlapping-
// match modular shortcut collapsing RLE pyramids to one hop per
// sequence.  Bit-identical to the numpy reference resolver
// (spans.resolve_ring_bytes, differential-tested).
//
// starts: [S+1] chain-local exclusive size prefix (starts[S] = n_out).
// Returns 0, or -1 when a chain walk exceeds the depth cap (the
// caller then simply does not span-split).
// ---------------------------------------------------------------------------

static inline int64_t rw_owner(const int32_t* starts, int64_t S,
                               int64_t p) {
    int64_t lo = 0, hi = S;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if ((int64_t)starts[mid] <= p) lo = mid + 1; else hi = mid;
    }
    return lo > 0 ? lo - 1 : 0;
}

// Owner of p when it is known to be < cap (walk hops move strictly
// backward, so the previous owner + 1 caps the search): gallop down
// from the cap, then bisect the bracketed range — O(log distance)
// with cache-adjacent probes, vs a full-range bisect per hop.
static inline int64_t rw_owner_down(const int32_t* starts, int64_t cap,
                                    int64_t p) {
    int64_t hi = cap, lo = cap - 1, step = 1;
    while (lo > 0 && (int64_t)starts[lo] > p) {
        hi = lo;
        lo -= step;
        if (lo < 0) lo = 0;
        step <<= 1;
    }
    if ((int64_t)starts[lo] > p) return 0;
    // owner in [lo, hi): starts[lo] <= p, starts[hi] > p
    while (lo + 1 < hi) {
        int64_t mid = (lo + hi) >> 1;
        if ((int64_t)starts[mid] <= p) lo = mid; else hi = mid;
    }
    return lo;
}

int32_t lz4tpu_resolve_window(
    const int32_t* ll, const int32_t* ml, const int32_t* mo,
    const int32_t* ls, int64_t S,
    const uint8_t* buf,
    const int32_t* starts,   // [S+1]
    int64_t B, int64_t W, uint8_t* out,
    int64_t hop_budget) {
    const int64_t lo = B - W;
    int64_t hops = 0;
    int64_t q = lo;
    if (q < 0) {
        // positions before the chain start are never referenced (the
        // scan validates back-references against the frame start)
        std::memset(out, 0, (size_t)(-q < W ? -q : W));
        q = 0;
    }
    if (q >= B) return 0;
    int64_t s = rw_owner(starts, S + 1, q);
    while (q < B) {
        while ((int64_t)starts[s + 1] <= q) ++s;
        const int64_t local = q - starts[s];
        const int64_t l = ll[s];
        if (local < l) {
            int64_t run = l - local;
            if (run > B - q) run = B - q;
            std::memcpy(out + (q - lo), buf + ls[s] + local,
                        (size_t)run);
            q += run;
            continue;
        }
        const int64_t off = mo[s] >= 1 ? mo[s] : 1;
        const int64_t mend = starts[s + 1];
        int64_t rem = mend - q;
        if (rem > B - q) rem = B - q;
        const int64_t src0 = q - off;
        if (src0 >= lo) {
            // ascending self-overlap-safe copy from resolved bytes
            uint8_t* d = out + (q - lo);
            const uint8_t* sp2 = out + (src0 - lo);
            if (off >= 16) {
                int64_t k = 0;
                for (; k + 16 <= rem; k += 16)
                    std::memcpy(d + k, sp2 + k, 16);
                for (; k < rem; ++k) d[k] = sp2[k];
            } else {
                for (int64_t k = 0; k < rem; ++k) d[k] = sp2[k];
            }
            q += rem;
            continue;
        }
        // Deep walk: this run's sources precede the window.  Each hop
        // shrinks `rem` to keep the run's chain structure uniform;
        // terminals are a literal run, or a hop back inside the
        // resolved window prefix.
        int64_t p = q;
        int64_t s_cap = s + 1;   // owner of p is always < s_cap
        int64_t depth = 0;
        for (;;) {
            // deep legitimate chains exist (an RLE pyramid crosses one
            // segment per hop), so the bound is a total work budget,
            // not a per-walk depth constant
            if (++depth, ++hops > hop_budget) return -1;
            const int64_t s2 = depth == 1
                ? s : rw_owner_down(starts, s_cap, p);
            s_cap = s2 + 1;
            const int64_t loc2 = p - starts[s2];
            const int64_t l2 = ll[s2];
            if (loc2 < l2) {
                if (l2 - loc2 < rem) rem = l2 - loc2;
                std::memcpy(out + (q - lo), buf + ls[s2] + loc2,
                            (size_t)rem);
                break;
            }
            const int64_t off2 = mo[s2] >= 1 ? mo[s2] : 1;
            const int64_t m0 = starts[s2] + l2;
            const int64_t seg_end = starts[s2 + 1];
            if (seg_end - p < rem) rem = seg_end - p;
            int64_t hop = p - off2;
            if (hop >= m0) {
                // overlapping match: collapse the pyramid in one hop;
                // consecutive sources stay consecutive until the
                // residue wraps mod off2
                const int64_t r2 = (p - m0) % off2;
                hop = m0 - off2 + r2;
                if (off2 - r2 < rem) rem = off2 - r2;
            }
            if (hop >= lo && hop < q) {
                if (q - hop < rem) rem = q - hop;
                uint8_t* d = out + (q - lo);
                const uint8_t* sp2 = out + (hop - lo);
                for (int64_t k = 0; k < rem; ++k) d[k] = sp2[k];
                break;
            }
            p = hop;
        }
        if (rem < 1) rem = 1;   // defensive: always progress
        q += rem;
    }
    return 0;
}


// Read back the last prep's per-range instrumentation rows (see
// fz_record_ranges).  Returns the row count; copies min(count, cap)
// rows of 4 int64 each into out.  Rows are only recorded while
// LZ4TPU_PREP_COUNTERS=1.
int64_t lz4tpu_prep_last_ranges(int64_t* out, int64_t cap) {
    std::lock_guard<std::mutex> g(fz_ranges_mu);
    const int64_t n = fz_ranges_n < cap ? fz_ranges_n : cap;
    if (n > 0)
        std::memcpy(out, fz_ranges_buf,
                    (size_t)(4 * n) * sizeof(int64_t));
    return fz_ranges_n;
}


}  // extern "C"
