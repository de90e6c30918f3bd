// knox_native — host-side encode/analyze kernels.
//
// The reference implements its encode hot loops in hand-written AVX2/
// AVX512 assembly (/root/reference/internal/encode/{analyze,bitpack}
// + internal/cmp). In this build the DEVICE side of those kernels is
// Pallas/XLA (ops/bitslice.py); this file is the HOST side: the write
// path's bitplane transpose and one-pass analysis, which run on CPU at
// merge/encode time and dominate segment build cost in pure numpy.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image):
//   bitplane_pack   u64 values -> u32 bitplanes  (bit p of row r ->
//                   plane p word r/32 bit r%32)
//   bitplane_unpack inverse (testing/oracle)
//   analyze_u64     min/max/#runs/zigzag-delta width/pack width, one pass
//
// Build: cc -O3 -march=native -shared -fPIC (see native/build.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

// values[n] -> planes[width][n_pad/32] (n_pad multiple of 32, zeros pad)
//
// Hot loop of segment build (the reference's codegen'd bitpack encode
// runs 33-53 GB/s, internal/encode/bitpack/bench.md). AVX-512 path:
// shift bit p of 16 lanes into the sign position, then a signed-<0
// compare mask IS the transposed plane half-word — ~4 instructions per
// plane word instead of a 32-iteration bit-gather loop. Word ranges
// are independent (disjoint stores), so big inputs fan out over
// hardware threads (the reference parallelizes encode with
// goroutines; table.go merge writers).
static void pack_range(const uint64_t* values, int64_t w_lo, int64_t w_hi,
                       int64_t words, int32_t width, uint32_t* planes) {
    const int32_t wlo = width < 32 ? width : 32;
    for (int64_t w = w_lo; w < w_hi; ++w) {
        const uint64_t* blk = values + w * 32;
#if defined(__AVX512F__)
        alignas(64) uint32_t lo[32], hi[32];
        for (int b = 0; b < 32; ++b) {
            lo[b] = (uint32_t)blk[b];
            hi[b] = (uint32_t)(blk[b] >> 32);
        }
        const __m512i z = _mm512_setzero_si512();
        const __m512i L0 = _mm512_load_si512((const void*)lo);
        const __m512i L1 = _mm512_load_si512((const void*)(lo + 16));
        for (int32_t p = 0; p < wlo; ++p) {
            const uint32_t m0 = _mm512_cmplt_epi32_mask(
                _mm512_slli_epi32(L0, 31 - p), z);
            const uint32_t m1 = _mm512_cmplt_epi32_mask(
                _mm512_slli_epi32(L1, 31 - p), z);
            planes[(size_t)p * words + w] = m0 | (m1 << 16);
        }
        if (width > 32) {
            const __m512i H0 = _mm512_load_si512((const void*)hi);
            const __m512i H1 = _mm512_load_si512((const void*)(hi + 16));
            for (int32_t p = 32; p < width; ++p) {
                const uint32_t m0 = _mm512_cmplt_epi32_mask(
                    _mm512_slli_epi32(H0, 63 - p), z);
                const uint32_t m1 = _mm512_cmplt_epi32_mask(
                    _mm512_slli_epi32(H1, 63 - p), z);
                planes[(size_t)p * words + w] = m0 | (m1 << 16);
            }
        }
#else
        uint64_t block[32];
        std::memcpy(block, blk, sizeof(block));
        for (int32_t p = 0; p < width; ++p) {
            uint32_t acc = 0;
            for (int b = 0; b < 32; ++b)
                acc |= (uint32_t)((block[b] >> p) & 1ull) << b;
            planes[(size_t)p * words + w] = acc;
        }
#endif
    }
}

void bitplane_pack(const uint64_t* values, int64_t n, int64_t n_pad,
                   int32_t width, uint32_t* planes) {
    const int64_t words = n_pad / 32;
    std::memset(planes, 0, sizeof(uint32_t) * (size_t)width * words);
    const int64_t full = n / 32;
    const unsigned hw = std::thread::hardware_concurrency();
    const int64_t min_per_thread = 2048;        // amortize spawn cost
    int64_t nt = hw ? (int64_t)hw : 1;
    if (nt > full / min_per_thread) nt = full / min_per_thread;
    if (nt > 1) {
        std::vector<std::thread> ts;
        const int64_t step = (full + nt - 1) / nt;
        for (int64_t t = 0; t < nt; ++t) {
            const int64_t lo_w = t * step;
            const int64_t hi_w = lo_w + step < full ? lo_w + step : full;
            if (lo_w >= hi_w) break;
            ts.emplace_back(pack_range, values, lo_w, hi_w, words, width,
                            planes);
        }
        for (auto& th : ts) th.join();
    } else {
        pack_range(values, 0, full, words, width, planes);
    }
    const int64_t tail = n % 32;
    if (tail) {
        const int64_t w = n / 32;
        for (int32_t p = 0; p < width; ++p) {
            uint32_t acc = 0;
            for (int64_t b = 0; b < tail; ++b)
                acc |= (uint32_t)((values[w * 32 + b] >> p) & 1ull) << b;
            planes[(size_t)p * words + w] = acc;
        }
    }
}

void bitplane_unpack(const uint32_t* planes, int64_t n, int64_t n_pad,
                     int32_t width, uint64_t* values) {
    const int64_t words = n_pad / 32;
    std::memset(values, 0, sizeof(uint64_t) * (size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t w = i / 32, b = i % 32;
        uint64_t v = 0;
        for (int32_t p = 0; p < width; ++p)
            v |= (uint64_t)((planes[(size_t)p * words + w] >> b) & 1u) << p;
        values[i] = v;
    }
}

// One-pass vector analysis (reference internal/encode/analyze).
// out[0]=min out[1]=max out[2]=num_runs out[3]=delta_width(zigzag bits)
// out[4]=pack_width(bits of max-min) out[5]=is_sorted(0/1)
// Range-associative (deltas/runs look back exactly one element, so a
// range [lo, hi) starting its scan at lo covers the lo-1 -> lo
// boundary itself) -> fans out over hardware threads like
// bitplane_pack.
struct AnalyzeAcc {
    uint64_t mn, mx, runs, zzmax;
    int sorted;
};

static void analyze_range(const uint64_t* values, int64_t lo, int64_t hi,
                          AnalyzeAcc* acc) {
    uint64_t mn = values[lo], mx = values[lo];
    uint64_t runs = 0, zzmax = 0;
    int sorted = 1;
    for (int64_t i = lo == 0 ? 1 : lo; i < hi; ++i) {
        const uint64_t v = values[i];
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        if (v != values[i - 1]) ++runs;
        const uint64_t d = v - values[i - 1];           // mod 2^64
        const int64_t sd = (int64_t)d;
        const uint64_t zz = ((uint64_t)(sd << 1)) ^ (uint64_t)(sd >> 63);
        if (zz > zzmax) zzmax = zz;
        if (sd < 0) sorted = 0;
    }
    acc->mn = mn;
    acc->mx = mx;
    acc->runs = runs;
    acc->zzmax = zzmax;
    acc->sorted = sorted;
}

void analyze_u64(const uint64_t* values, int64_t n, uint64_t* out) {
    const unsigned hw = std::thread::hardware_concurrency();
    int64_t nt = hw ? (int64_t)hw : 1;
    const int64_t min_per_thread = 1 << 16;
    if (nt > n / min_per_thread) nt = n / min_per_thread;
    if (nt < 1) nt = 1;
    std::vector<AnalyzeAcc> accs((size_t)nt);
    if (nt > 1) {
        std::vector<std::thread> ts;
        const int64_t step = (n + nt - 1) / nt;
        for (int64_t t = 0; t < nt; ++t) {
            const int64_t lo = t * step;
            const int64_t hi = lo + step < n ? lo + step : n;
            ts.emplace_back(analyze_range, values, lo, hi,
                            &accs[(size_t)t]);
        }
        for (auto& th : ts) th.join();
    } else {
        analyze_range(values, 0, n, &accs[0]);
    }
    AnalyzeAcc a = accs[0];
    a.runs += 1;                         // first element opens a run
    for (size_t t = 1; t < accs.size(); ++t) {
        const AnalyzeAcc& b = accs[t];
        if (b.mn < a.mn) a.mn = b.mn;
        if (b.mx > a.mx) a.mx = b.mx;
        a.runs += b.runs;
        if (b.zzmax > a.zzmax) a.zzmax = b.zzmax;
        a.sorted &= b.sorted;
    }
    out[0] = a.mn;
    out[1] = a.mx;
    out[2] = a.runs;
    uint64_t w = 0;
    while (a.zzmax >> w && w < 64) ++w;
    out[3] = (n > 1) ? w : 0;
    const uint64_t range = a.mx - a.mn;
    w = 0;
    while (range >> w && w < 64) ++w;
    out[4] = w;
    out[5] = (uint64_t)a.sorted;
}

// Packed u32 bitset -> ascending row indexes (selection vector).
// Returns count; idx must have room for popcount.
int64_t bitset_indexes(const uint32_t* words, int64_t n_words,
                       uint32_t base, uint32_t* idx) {
    int64_t k = 0;
    for (int64_t w = 0; w < n_words; ++w) {
        uint32_t m = words[w];
        while (m) {
            const int b = __builtin_ctz(m);
            idx[k++] = base + (uint32_t)(w * 32 + b);
            m &= m - 1;
        }
    }
    return k;
}

// ---------------------------------------------------------------- lz4 --
// LZ4 BLOCK format (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md)
// compress/decompress — the reference offers snappy/lz4/zstd outer
// block codecs (internal/block/compress.go:54-70); this supplies the
// lz4-class fast-decode point (no lz4 python module in this image).
// Greedy single-pass hash-table matcher; decompressor validates bounds
// and returns -1 on malformed input.

static inline uint32_t lz4_hash32(uint32_t v) {
    return (v * 2654435761u) >> 20;              // 12-bit bucket
}

int64_t lz4_compress_bound(int64_t n) { return n + n / 255 + 16; }

int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                     int64_t cap) {
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    int64_t anchor = 0;
    std::vector<int64_t> table(1 << 12, -1);
    if (n >= 13) {
        const int64_t mstart_limit = n - 12;     // last match start bound
        const int64_t mend_limit = n - 5;        // last 5 bytes literal
        int64_t i = 0;
        while (i <= mstart_limit) {
            uint32_t seq;
            std::memcpy(&seq, src + i, 4);
            const uint32_t h = lz4_hash32(seq);
            const int64_t cand = table[h];
            table[h] = i;
            uint32_t cseq = 0;
            if (cand >= 0 && i - cand <= 65535) {
                std::memcpy(&cseq, src + cand, 4);
            }
            if (cand < 0 || i - cand > 65535 || cseq != seq) {
                ++i;
                continue;
            }
            int64_t mlen = 4;
            const int64_t maxm = mend_limit - i;
            while (mlen < maxm && src[cand + mlen] == src[i + mlen])
                ++mlen;
            const int64_t lit = i - anchor;
            // token + ext lens + literals + offset + slack
            if (op + 1 + lit / 255 + 1 + lit + 2 + mlen / 255 + 1 > oend)
                return -1;
            uint8_t* tok = op++;
            int64_t l = lit;
            if (l >= 15) {
                *tok = (uint8_t)(15 << 4);
                l -= 15;
                while (l >= 255) { *op++ = 255; l -= 255; }
                *op++ = (uint8_t)l;
            } else {
                *tok = (uint8_t)(l << 4);
            }
            std::memcpy(op, src + anchor, lit);
            op += lit;
            const uint16_t off = (uint16_t)(i - cand);
            std::memcpy(op, &off, 2);
            op += 2;
            int64_t m = mlen - 4;
            if (m >= 15) {
                *tok |= 15;
                m -= 15;
                while (m >= 255) { *op++ = 255; m -= 255; }
                *op++ = (uint8_t)m;
            } else {
                *tok |= (uint8_t)m;
            }
            i += mlen;
            anchor = i;
        }
    }
    // final literal run
    const int64_t lit = n - anchor;
    if (op + 1 + lit / 255 + 1 + lit > oend) return -1;
    uint8_t* tok = op++;
    int64_t l = lit;
    if (l >= 15) {
        *tok = (uint8_t)(15 << 4);
        l -= 15;
        while (l >= 255) { *op++ = 255; l -= 255; }
        *op++ = (uint8_t)l;
    } else {
        *tok = (uint8_t)(l << 4);
    }
    std::memcpy(op, src + anchor, lit);
    op += lit;
    return op - dst;
}

int64_t lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    while (ip < iend) {
        const uint8_t token = *ip++;
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, lit);
        op += lit;
        ip += lit;
        if (ip >= iend) break;                   // last sequence
        if (ip + 2 > iend) return -1;
        uint16_t off;
        std::memcpy(&off, ip, 2);
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t mlen = (token & 15) + 4;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > oend) return -1;
        const uint8_t* m = op - off;
        for (int64_t j = 0; j < mlen; ++j) op[j] = m[j];  // overlap-safe
        op += mlen;
    }
    return op - dst;
}

}  // extern "C"
