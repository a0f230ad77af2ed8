// Native host codecs: NibblePack pack/unpack + delta-delta residuals.
//
// Reference role: the JVM reference's hot encode path is hand-rolled Scala over
// sun.misc.Unsafe (memory/.../format/NibblePack.scala); here the equivalent
// native layer is C++ compiled to a shared library and loaded via ctypes
// (filodb_tpu_torch/memory/native/__init__.py). The Python/numpy implementations in
// nibblepack.py remain the reference/spec implementation; these functions are
// bit-identical (tested in test_native.py) and used on the ingest/persistence
// hot path where Python-loop decode would bottleneck.
//
// Build: memory/native/build.sh -> libfilodb_codecs.so

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int leading_zero_nibbles(uint64_t v) {
    if (v == 0) return 16;
    return __builtin_clzll(v) / 4;
}

inline int trailing_zero_nibbles(uint64_t v) {
    if (v == 0) return 16;
    return __builtin_ctzll(v) / 4;
}

// Pack one group of 8 words; returns bytes written.
inline size_t pack8(const uint64_t* in, uint8_t* out) {
    uint8_t bitmask = 0;
    int lead = 16, trail = 16;
    for (int i = 0; i < 8; i++) {
        if (in[i] != 0) {
            bitmask |= (uint8_t)(1u << i);
            int lz = leading_zero_nibbles(in[i]);
            int tz = trailing_zero_nibbles(in[i]);
            if (lz < lead) lead = lz;
            if (tz < trail) trail = tz;
        }
    }
    out[0] = bitmask;
    if (bitmask == 0) return 1;
    int nnib = 16 - lead - trail;
    out[1] = (uint8_t)(trail | ((nnib - 1) << 4));
    size_t nibpos = 0;   // nibble index within the stream starting at out+2
    uint8_t* data = out + 2;
    // stream is zero-initialized by caller requirement: we clear as we go
    size_t totnib_max = (size_t)nnib * 8;
    memset(data, 0, (totnib_max + 1) / 2);
    for (int i = 0; i < 8; i++) {
        if (!(bitmask & (1u << i))) continue;
        uint64_t v = in[i] >> (4 * trail);
        for (int k = 0; k < nnib; k++) {
            uint8_t nib = (uint8_t)((v >> (4 * k)) & 0xF);
            data[nibpos >> 1] |= (uint8_t)(nib << ((nibpos & 1) * 4));
            nibpos++;
        }
    }
    return 2 + (nibpos + 1) / 2;
}

inline size_t unpack8(const uint8_t* in, uint64_t* out) {
    uint8_t bitmask = in[0];
    for (int i = 0; i < 8; i++) out[i] = 0;
    if (bitmask == 0) return 1;
    int trail = in[1] & 0xF;
    int nnib = (in[1] >> 4) + 1;
    const uint8_t* data = in + 2;
    size_t nibpos = 0;
    for (int i = 0; i < 8; i++) {
        if (!(bitmask & (1u << i))) continue;
        uint64_t v = 0;
        for (int k = 0; k < nnib; k++) {
            uint64_t nib = (data[nibpos >> 1] >> ((nibpos & 1) * 4)) & 0xF;
            v |= nib << (4 * k);
            nibpos++;
        }
        out[i] = v << (4 * trail);
    }
    return 2 + (nibpos + 1) / 2;
}

}  // namespace

extern "C" {

// Pack n u64 words; out must have room for n/8*34+34 bytes. Returns bytes written.
size_t np_pack_u64(const uint64_t* in, size_t n, uint8_t* out) {
    size_t pos = 0;
    uint64_t group[8];
    size_t full = n / 8;
    for (size_t g = 0; g < full; g++) {
        pos += pack8(in + g * 8, out + pos);
    }
    size_t rem = n % 8;
    if (rem) {
        memset(group, 0, sizeof(group));
        memcpy(group, in + full * 8, rem * sizeof(uint64_t));
        pos += pack8(group, out + pos);
    }
    return pos;
}

// Unpack n u64 words; returns bytes consumed.
size_t np_unpack_u64(const uint8_t* in, size_t n, uint64_t* out) {
    size_t pos = 0;
    uint64_t group[8];
    size_t groups = (n + 7) / 8;
    for (size_t g = 0; g < groups; g++) {
        pos += unpack8(in + pos, group);
        size_t take = (g == groups - 1 && n % 8) ? n % 8 : 8;
        memcpy(out + g * 8, group, take * sizeof(uint64_t));
    }
    return pos;
}

// XOR-chain doubles (Gorilla predictor): out[0] unused; caller writes head raw.
void xor_chain(const uint64_t* bits, size_t n, uint64_t* out) {
    for (size_t i = 1; i < n; i++) out[i - 1] = bits[i] ^ bits[i - 1];
}

void xor_unchain(uint64_t head, const uint64_t* xored, size_t n, uint64_t* out) {
    out[0] = head;
    for (size_t i = 1; i < n; i++) out[i] = out[i - 1] ^ xored[i - 1];
}

// delta-delta residuals vs the sloped line: resid[i] = v[i] - (first + slope*i),
// zigzag-encoded into u64 (ref: doc/compression.md Long/Integer Compression).
void dd_residuals(const int64_t* v, size_t n, int64_t first, int64_t slope,
                  uint64_t* out) {
    for (size_t i = 0; i < n; i++) {
        int64_t r = v[i] - (first + slope * (int64_t)i);
        out[i] = (uint64_t)((r << 1) ^ (r >> 63));
    }
}

void dd_restore(const uint64_t* zz, size_t n, int64_t first, int64_t slope,
                int64_t* out) {
    for (size_t i = 0; i < n; i++) {
        int64_t r = (int64_t)(zz[i] >> 1) ^ -(int64_t)(zz[i] & 1);
        out[i] = first + slope * (int64_t)i + r;
    }
}

// 2D-delta histogram series codec (ref: HistogramVector.scala sectioned
// vectors, doc/compression.md "2D Delta Compression"): row 0 packs its own
// bucket deltas; row t>0 packs zigzag(deltas_t - deltas_{t-1}). Wire-equal
// to the numpy spec in memory/hist.py (whole series in ONE call — the
// per-row Python loop was the flush/recovery bottleneck).
size_t hist_encode(const int64_t* c, size_t n, size_t B, uint8_t* out) {
    int64_t* prev = (int64_t*)std::malloc(B * sizeof(int64_t));
    int64_t* cur = (int64_t*)std::malloc(B * sizeof(int64_t));
    uint64_t* zz = (uint64_t*)std::malloc(((B + 7) & ~(size_t)7) * sizeof(uint64_t));
    size_t pos = 0;
    for (size_t i = 0; i < n; i++) {
        const int64_t* row = c + i * B;
        for (size_t j = 0; j < B; j++)
            cur[j] = row[j] - (j ? row[j - 1] : 0);
        if (i == 0) {
            for (size_t j = 0; j < B; j++) zz[j] = (uint64_t)cur[j];
        } else {
            for (size_t j = 0; j < B; j++) {
                int64_t d = cur[j] - prev[j];
                zz[j] = (uint64_t)((d << 1) ^ (d >> 63));
            }
        }
        pos += np_pack_u64(zz, B, out + pos);
        int64_t* t = prev; prev = cur; cur = t;
    }
    std::free(prev); std::free(cur); std::free(zz);
    return pos;
}

// Decodes n rows of B cumulative buckets; returns bytes consumed.
size_t hist_decode(const uint8_t* in, size_t n, size_t B, int64_t* out) {
    size_t Bpad = (B + 7) & ~(size_t)7;
    uint64_t* words = (uint64_t*)std::malloc(Bpad * sizeof(uint64_t));
    int64_t* deltas = (int64_t*)std::malloc(B * sizeof(int64_t));
    size_t pos = 0;
    for (size_t i = 0; i < n; i++) {
        pos += np_unpack_u64(in + pos, B, words);
        if (i == 0) {
            for (size_t j = 0; j < B; j++) deltas[j] = (int64_t)words[j];
        } else {
            for (size_t j = 0; j < B; j++) {
                int64_t d = (int64_t)(words[j] >> 1) ^ -(int64_t)(words[j] & 1);
                deltas[j] += d;
            }
        }
        int64_t acc = 0;
        int64_t* row = out + i * B;
        for (size_t j = 0; j < B; j++) {
            acc += deltas[j];
            row[j] = acc;
        }
    }
    std::free(words); std::free(deltas);
    return pos;
}

// sub-byte bit-packing for the IntBinaryVector family (bits in {1, 2, 4}):
// values pack little-endian within each byte (ref: IntBinaryVector.scala
// bit-packed int vectors; layout spec in memory/intpack.py).
size_t np_pack_subbyte(const uint64_t* in, size_t n, int bits, uint8_t* out) {
    int per = 8 / bits;
    size_t nbytes = (n + (size_t)per - 1) / (size_t)per;
    for (size_t b = 0; b < nbytes; b++) {
        uint8_t acc = 0;
        for (int j = 0; j < per; j++) {
            size_t i = b * (size_t)per + (size_t)j;
            if (i < n) acc |= (uint8_t)(in[i] << (j * bits));
        }
        out[b] = acc;
    }
    return nbytes;
}

void np_unpack_subbyte(const uint8_t* in, size_t n, int bits, uint64_t* out) {
    int per = 8 / bits;
    uint8_t mask = (uint8_t)((1u << bits) - 1u);
    for (size_t i = 0; i < n; i++)
        out[i] = (uint64_t)((in[i / (size_t)per] >> ((i % (size_t)per) * (size_t)bits)) & mask);
}

}  // extern "C"
