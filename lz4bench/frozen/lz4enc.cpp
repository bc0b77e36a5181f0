// lz4bench's frozen LZ4 frame encoder core: the hash-chain block encoder
// and xxhash32 of lz4tpu_torch/native/lz4core.cpp, copied as they stood
// when the benchmark was defined.  The benchmark writes its decode
// inputs with this copy, so the frames, and the engine mix they give,
// do not move when the program's own encoder does.  Built by
// lz4bench/encoder.py with g++ into lz4bench/_build/; plain C ABI.

#include <cstdint>
#include <cstring>

extern "C" {

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

// One-shot xxhash32 (the stripe loop of lz4tpu_xxh32_update and
// lz4tpu_xxh32_final over a whole buffer).
uint32_t lz4bench_xxh32(const uint8_t* data, int64_t n, uint32_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    uint32_t h;
    if (n >= 16) {
        uint32_t s0 = seed + P1 + P2, s1 = seed + P2, s2 = seed,
                 s3 = seed - P1;
        while (end - p >= 16) {
            s0 = rotl32(s0 + read32(p + 0) * P2, 13) * P1;
            s1 = rotl32(s1 + read32(p + 4) * P2, 13) * P1;
            s2 = rotl32(s2 + read32(p + 8) * P2, 13) * P1;
            s3 = rotl32(s3 + read32(p + 12) * P2, 13) * P1;
            p += 16;
        }
        h = rotl32(s0, 1) + rotl32(s1, 7) + rotl32(s2, 12) + rotl32(s3, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)n;
    while (end - p >= 4) {
        h = rotl32(h + read32(p) * P3, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h = rotl32(h + (*p) * P5, 11) * P1;
        p += 1;
    }
    h ^= h >> 15; h *= P2;
    h ^= h >> 13; h *= P3;
    h ^= h >> 16;
    return h;
}

static inline uint32_t hash_seq(uint32_t v) {
    return (v * 2654435761u) >> (32 - 16);  // 16-bit hash table
}

// Compress one block. `hist` may point at up to 64 KiB of preceding
// output (linked blocks); pass hist_len = 0 for independent blocks.
// Returns compressed size, or -1 if it would exceed dst capacity, or 0
// for an empty input.
int64_t lz4bench_compress_block(
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

}  // extern "C"
