// vc2host — native host-side entropy codec for vc2tpu.
//
// The device generates, per coefficient lane, an interleaved exp-Golomb code
// word and bit length; this module scatters those into the byte stream
// (pack) and runs the sequential bounded-region exp-Golomb decode (unpack).
// Bounded-region semantics mirror the reference bit engine
// (/root/reference/src/Library/src/VLC.cpp:149-257): writes beyond a bound
// drop 1-bits, reads beyond a bound return 1-bits.
//
// Built as a plain C ABI shared object, loaded with ctypes (no pybind11).

#include <cstdint>
#include <cstring>

#if defined(__BMI2__)
#include <immintrin.h>
#endif

#if defined(_MSC_VER)
#define EXPORT extern "C" __declspec(dllexport)
#else
#define EXPORT extern "C" __attribute__((visibility("default")))
#endif

static inline uint64_t bswap64(uint64_t v) {
#if defined(__GNUC__)
  return __builtin_bswap64(v);
#else
  v = ((v & 0x00000000FFFFFFFFull) << 32) | (v >> 32);
  v = ((v & 0x0000FFFF0000FFFFull) << 16) | ((v >> 16) & 0x0000FFFF0000FFFFull);
  v = ((v & 0x00FF00FF00FF00FFull) << 8) | ((v >> 8) & 0x00FF00FF00FF00FFull);
  return v;
#endif
}

// Scatter `n` codes into `out` (size >= 8*ceil(total_bits/64), zeroed by the
// caller). Code i occupies bits [off[i], off[i]+nbits[i]) of the big-endian
// bit stream; bits at or past total_bits are dropped (they are all 1-bits of
// trailing zero-value codes by construction).
EXPORT void pack_codes(const uint64_t* codes, const uint32_t* nbits,
                       const int64_t* off, int64_t n, int64_t total_bits,
                       uint8_t* out) {
  uint64_t* words = reinterpret_cast<uint64_t*>(out);
  for (int64_t i = 0; i < n; ++i) {
    int64_t o = off[i];
    int64_t nb = static_cast<int64_t>(nbits[i]);
    if (o >= total_bits) continue;
    int64_t end = o + nb;
    if (end > total_bits) {  // drop the tail past the bound
      int64_t drop = end - total_bits;
      nb -= drop;
      end = total_bits;
    }
    // putBits writes only the low nbits of a value (VLC.cpp:259-281):
    // mask first so a too-wide value cannot bleed into the preceding
    // field's bytes (same contract as bitpack.pack_codes' NumPy twin)
    uint64_t full = nbits[i] >= 64 ? ~0ull : ((1ull << nbits[i]) - 1);
    uint64_t code = (codes[i] & full) >> (static_cast<int64_t>(nbits[i]) - nb);
    int64_t w0 = o >> 6;
    int64_t avail = 64 - (o & 63);
    if (nb <= avail) {
      words[w0] |= bswap64(code << (avail - nb));
    } else {
      int64_t overflow = nb - avail;
      words[w0] |= bswap64(code >> overflow);
      words[w0 + 1] |= bswap64((code & ((1ull << overflow) - 1)) << (64 - overflow));
    }
  }
}

static inline int get_bit(const uint8_t* buf, int64_t buflen, int64_t bitpos) {
  int64_t byte = bitpos >> 3;
  if (byte >= buflen) return 1;
  return (buf[byte] >> (7 - (bitpos & 7))) & 1;
}

// 64 bits of the big-endian bit stream starting at absolute bit `abs_pos`,
// with every bit at or past the bound (bits_left from abs_pos) and every
// byte past the buffer end reading as 1 — the bounded-region rule
// (reference VLC.cpp:182-185).
static inline uint64_t peek64(const uint8_t* buf, int64_t buflen,
                              int64_t abs_pos, int64_t bits_left) {
  const int64_t byte = abs_pos >> 3;
  const int shift = static_cast<int>(abs_pos & 7);
  uint64_t w;
  if (byte + 9 <= buflen) {
    uint64_t a;
    std::memcpy(&a, buf + byte, 8);
    a = bswap64(a);
    w = a << shift;
    if (shift) w |= static_cast<uint64_t>(buf[byte + 8]) >> (8 - shift);
  } else {
    uint64_t a = 0;
    for (int i = 0; i < 8; ++i)
      a = (a << 8) | ((byte + i < buflen) ? buf[byte + i] : 0xFFu);
    w = a << shift;
    if (shift) {
      const uint64_t b = (byte + 8 < buflen) ? buf[byte + 8] : 0xFFu;
      w |= b >> (8 - shift);
    }
  }
  if (bits_left < 64) w |= (bits_left <= 0) ? ~0ull : (~0ull >> bits_left);
  return w;
}

// Decode S bounded exp-Golomb streams of n_lanes signed values each.
// start[s] is the absolute first bit, bound[s] the region length in bits.
//
// Fast path: load a 64-bit window; the interleaved code's follow bits sit at
// even offsets (mask 0xAA..), so count-leading-zeros of the masked window
// gives the code length directly and the data bits (odd offsets) extract
// with PEXT / a short shift loop. One window decodes one whole code
// (magnitude <= 2^30 spans <= 64 bits) instead of one bit per call.

// Magnitude of one interleaved exp-Golomb code from a 64-bit MSB-first
// window whose first bit is the code's first follow/data pair: j data bits
// sit at the even positions; the implicit leading 1 makes
// mag = ((1 << j) | data) - 1. The ONE copy of this bit-exactness-critical
// extraction (every decode route calls it).
static inline uint32_t golomb_mag(uint64_t w, int j) {
  if (j <= 0) return 0;
#if defined(__BMI2__)
  const uint32_t data =
      static_cast<uint32_t>(_pext_u64(w, 0x5555555555555555ull));
  return ((1u << j) | (data >> (32 - j))) - 1u;
#else
  uint32_t data = 0;
  for (int t = 0; t < j; ++t)
    data = (data << 1) | static_cast<uint32_t>((w >> (62 - 2 * t)) & 1);
  return ((1u << j) | data) - 1u;
#endif
}

EXPORT void unpack_streams(const uint8_t* buf, int64_t buflen,
                           const int64_t* start, const int64_t* bound,
                           int64_t S, int64_t n_lanes, int32_t* out) {
  for (int64_t s = 0; s < S; ++s) {
    int64_t pos = 0;
    const int64_t lim = bound[s];
    const int64_t base = start[s];
    int32_t* row = out + s * n_lanes;
    int64_t lane = 0;
    while (lane < n_lanes) {
      if (pos >= lim) {  // only virtual 1-bits remain -> zeros
        for (; lane < n_lanes; ++lane) row[lane] = 0;
        break;
      }
      const uint64_t w = peek64(buf, buflen, base + pos, lim - pos);
      const uint64_t follow = w & 0xAAAAAAAAAAAAAAAAull;
      if (follow == 0) {
        // > 2^32 magnitude (corrupt stream): bit-serial fallback for this value
        uint32_t value = 1;
        for (;;) {
          int b = (pos < lim) ? get_bit(buf, buflen, base + pos) : 1;
          ++pos;
          if (b) break;
          int d = (pos < lim) ? get_bit(buf, buflen, base + pos) : 1;
          ++pos;
          value = (value << 1) | static_cast<uint32_t>(d);
        }
        int32_t v = static_cast<int32_t>(value - 1);
        if (v != 0) {
          int sign = (pos < lim) ? get_bit(buf, buflen, base + pos) : 1;
          ++pos;
          if (sign) v = -v;
        }
        row[lane++] = v;
        continue;
      }
      const int j = __builtin_clzll(follow) >> 1;  // zero follow bits
      int consumed = 2 * j + 1;
      const uint32_t mag = golomb_mag(w, j);
      int32_t v = static_cast<int32_t>(mag);
      if (v != 0) {
        if (w >> (63 - consumed) & 1) v = -v;  // sign bit at offset 2j+1
        ++consumed;
      }
      row[lane++] = v;
      pos += consumed;
    }
  }
}

// unpack_streams variant writing int16 lanes (halves the host->device copy)
// and the per-stream fixed-pack bit width (bitlen(max|v|)+1, 0 when all
// zero) so the repack needs no extra max scan. Returns 1 if any magnitude
// exceeded int16 range (caller falls back to the int32 path to preserve
// bit-exactness), else 0.
EXPORT int unpack_streams_i16(const uint8_t* buf, int64_t buflen,
                              const int64_t* start, const int64_t* bound,
                              int64_t S, int64_t n_lanes, int16_t* out,
                              uint8_t* widths) {
  int overflow = 0;
  for (int64_t s = 0; s < S; ++s) {
    int64_t pos = 0;
    const int64_t lim = bound[s];
    const int64_t base = start[s];
    int16_t* row = out + s * n_lanes;
    uint32_t maxabs = 0;
    int64_t lane = 0;
    // decode one code at [base+pos] via a fresh bound-masked 64-bit peek —
    // the safe path used near the region end and for pathological codes
    auto decode_one_peek = [&]() {
      const uint64_t w = peek64(buf, buflen, base + pos, lim - pos);
      const uint64_t follow = w & 0xAAAAAAAAAAAAAAAAull;
      if (follow == 0) { overflow = 1; row[lane++] = 0; pos = lim; return; }
      const int j = __builtin_clzll(follow) >> 1;
      int consumed = 2 * j + 1;
      const uint32_t mag = golomb_mag(w, j);
      if (mag > 32767u) overflow = 1;
      if (mag > maxabs) maxabs = mag;
      int32_t v = static_cast<int32_t>(mag);
      if (v != 0) {
        if (w >> (63 - consumed) & 1) v = -v;
        ++consumed;
      }
      row[lane++] = static_cast<int16_t>(v);
      pos += consumed;
    };
    while (lane < n_lanes) {
      if (pos >= lim) {
        for (; lane < n_lanes; ++lane) row[lane] = 0;
        break;
      }
      if (pos + 64 > lim) {         // tail regime: bound-masked per-code peek
        decode_one_peek();
        continue;
      }
      if (((base + pos) >> 3) + 9 > buflen) {  // window would cross the
        decode_one_peek();                     // buffer end: masked peek
        continue;
      }
      // Rolling-window fast regime: the window lies wholly inside the bound
      // and the buffer, so no masking is needed. One unaligned 64-bit load
      // serves several codes (typical code: 3-17 bits); reload when fewer
      // than 41 bits remain, so every code with j <= 19 (magnitude < 2^20 —
      // far beyond the int16 overflow horizon) decodes in-register.
      {
        auto load_window = [&](int64_t abspos) {
          const int64_t fb = abspos >> 3;
          const int mis = static_cast<int>(abspos & 7);
          uint64_t a;
          std::memcpy(&a, buf + fb, 8);
          uint64_t win = bswap64(a) << mis;
          if (mis) win |= static_cast<uint64_t>(buf[fb + 8]) >> (8 - mis);
          return win;
        };
        uint64_t w = load_window(base + pos);
        int navail = 64;
        while (lane < n_lanes && pos + 64 <= lim) {
          if (navail <= 40) {
            if (((base + pos) >> 3) + 9 > buflen) break;  // back to peek path
            w = load_window(base + pos);
            navail = 64;
          }
          const uint64_t follow = w & 0xAAAAAAAAAAAAAAAAull;
          int j;
          if (follow == 0 || (j = __builtin_clzll(follow) >> 1,
                              2 * j + 2 > navail)) {
            decode_one_peek();      // pathological code: re-sync the window
            break;
          }
          int consumed = 2 * j + 1;
          const uint32_t mag = golomb_mag(w, j);
          if (mag > 32767u) overflow = 1;
          if (mag > maxabs) maxabs = mag;
          int32_t v = static_cast<int32_t>(mag);
          if (v != 0) {
            if (w >> (63 - consumed) & 1) v = -v;
            ++consumed;
          }
          row[lane++] = static_cast<int16_t>(v);
          pos += consumed;
          w <<= consumed;
          navail -= consumed;
        }
      }
    }
    widths[s] = static_cast<uint8_t>(maxabs ? (33 - __builtin_clz(maxabs))
                                            : 0);
  }
  return overflow;
}

// Fixed-width repack of decoded coefficient streams for the host->device
// copy: per stream (slice component) the width is bitlen(max|v|)+1 bits
// (0 for all-zero streams), values are two's-complement MSB-first,
// bit-contiguous across values and streams. The device unpacks with two
// word gathers + an arithmetic shift per value. Returns the end bit cursor.
EXPORT int64_t fixedpack(const int16_t* lanes, int64_t S, int64_t n_lanes,
                         uint8_t* widths, uint32_t* out, int64_t start_bit,
                         int widths_in) {
  int64_t bit = start_bit;
  for (int64_t s = 0; s < S; ++s) {
    const int16_t* row = lanes + s * n_lanes;
    int w;
    if (widths_in) {
      w = widths[s];            // precomputed by unpack_streams_i16
    } else {
      uint32_t maxabs = 0;
      for (int64_t i = 0; i < n_lanes; ++i) {
        int32_t v = row[i];
        uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
        if (a > maxabs) maxabs = a;
      }
      w = maxabs ? (33 - __builtin_clz(maxabs)) : 0;  // bitlen + sign bit
      widths[s] = static_cast<uint8_t>(w);
    }
    if (w == 0) continue;
    const uint32_t mask = (w == 32) ? ~0u : ((1u << w) - 1u);
    for (int64_t i = 0; i < n_lanes; ++i) {
      const uint32_t u = static_cast<uint32_t>(row[i]) & mask;
      const int64_t word = bit >> 5;
      const int sh = static_cast<int>(bit & 31);
      const int spill = sh + w - 32;
      if (spill <= 0) {
        out[word] |= u << (32 - sh - w);
      } else {
        out[word] |= u >> spill;
        out[word + 1] |= u << (32 - spill);
      }
      bit += w;
    }
  }
  return bit;
}

// Expand the device's 3x10-bit-per-word packed output samples to the
// big-endian MSB-justified 16-bit planar wire format (the decode tail's
// host post-processing; auto-vectorises under -O3 -march=native).
EXPORT void unpack10_to_be16(const uint32_t* words, int64_t n_words,
                             int64_t n_samples, uint16_t* out) {
  // thirds layout (decoder._pack10_words): word i packs samples
  // (i, i+n_words, i+2*n_words) — lane-aligned on the device side
  for (int64_t t = 0; t < 3; ++t) {
    const int sh = 20 - 10 * static_cast<int>(t);
    const int64_t base = t * n_words;
    int64_t end = n_samples - base;
    if (end > n_words) end = n_words;
    for (int64_t i = 0; i < end; ++i) {
      const uint16_t v =
          static_cast<uint16_t>(((words[i] >> sh) & 1023u) << 6);
      out[base + i] = static_cast<uint16_t>((v >> 8) | (v << 8));
    }
  }
}

// Walk the self-describing HQ (VBR-layout) slice chain: per slice `prefix`
// zero bytes, 1-byte qIndex, then 3 x {1-byte length/scalar, data}
// (reference Slices.cpp:384-467). Fills q[N], dstart[3*N], cbytes[3*N]
// (component-major) and returns the end offset, or -1 if the chain runs past
// the payload.
EXPORT int64_t scan_hq_offsets(const uint8_t* payload, int64_t paylen,
                               int64_t n, int64_t prefix, int64_t scalar,
                               int64_t start, int32_t* q, int64_t* dstart,
                               int64_t* cbytes) {
  int64_t pos = start;
  for (int64_t i = 0; i < n; ++i) {
    pos += prefix;
    if (pos >= paylen) return -1;
    q[i] = payload[pos];
    ++pos;
    for (int c = 0; c < 3; ++c) {
      if (pos >= paylen) return -1;
      const int64_t size = static_cast<int64_t>(payload[pos]) * scalar;
      ++pos;
      dstart[c * n + i] = pos;
      cbytes[c * n + i] = size;
      pos += size;
    }
  }
  // component data of the final slice may have skipped past the payload
  if (pos > paylen) return -1;
  return pos;
}

// Generate the interleaved exp-Golomb (signed) code word + bit length for
// each int32 lane (reference VLC.cpp:21-94). Codes are MSB-first in the low
// `nbits` bits of the uint64.
EXPORT void encode_lanes(const int32_t* lanes, int64_t n, uint64_t* codes,
                         uint32_t* nbits) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = lanes[i];
    if (v == 0) { codes[i] = 1; nbits[i] = 1; continue; }
    uint32_t u = static_cast<uint32_t>(v < 0 ? -v : v) + 1;
    int k = 32 - __builtin_clz(u);
    uint64_t bits = 0;
    for (int j = k - 2; j >= 0; --j) {
      bits <<= 2;
      if ((u >> j) & 1) bits |= 1;
    }
    bits = (bits << 1) | 1;             // terminator
    bits = (bits << 1) | (v < 0 ? 1 : 0);  // sign
    codes[i] = bits;
    nbits[i] = static_cast<uint32_t>(2 * k);
  }
}

// ------------------------------------------------------------------ LD path
// The Low Delay profile couples slices through LL-subband DC prediction
// (reference Quantisation.cpp:191-306, EncodeStream.cpp:141-245), a strict
// raster recurrence — it runs on the host.

static const uint32_t kQuantFactor[120] = {
    0x000000004u, 0x000000005u, 0x000000006u, 0x000000007u, 0x000000008u, 0x00000000Au, 0x00000000Bu, 0x00000000Du,
    0x000000010u, 0x000000013u, 0x000000017u, 0x00000001Bu, 0x000000020u, 0x000000026u, 0x00000002Du, 0x000000036u,
    0x000000040u, 0x00000004Cu, 0x00000005Bu, 0x00000006Cu, 0x000000080u, 0x000000098u, 0x0000000B5u, 0x0000000D7u,
    0x000000100u, 0x000000130u, 0x00000016Au, 0x0000001AFu, 0x000000200u, 0x000000261u, 0x0000002D4u, 0x00000035Du,
    0x000000400u, 0x0000004C2u, 0x0000005A8u, 0x0000006BAu, 0x000000800u, 0x000000983u, 0x000000B50u, 0x000000D74u,
    0x000001000u, 0x000001307u, 0x0000016A1u, 0x000001AE9u, 0x000002000u, 0x00000260Eu, 0x000002D41u, 0x0000035D1u,
    0x000004000u, 0x000004C1Cu, 0x000005A82u, 0x000006BA2u, 0x000008000u, 0x000009838u, 0x00000B505u, 0x00000D745u,
    0x000010000u, 0x000013070u, 0x000016A0Au, 0x00001AE8Au, 0x000020000u, 0x0000260E0u, 0x00002D414u, 0x000035D14u,
    0x000040000u, 0x00004C1C0u, 0x00005A828u, 0x00006BA28u, 0x000080000u, 0x00009837Fu, 0x0000B504Fu, 0x0000D7450u,
    0x000100000u, 0x0001306FEu, 0x00016A09Eu, 0x0001AE8A0u, 0x000200000u, 0x000260DFCu, 0x0002D413Du, 0x00035D13Fu,
    0x000400000u, 0x0004C1BF8u, 0x0005A827Au, 0x0006BA27Eu, 0x000800000u, 0x0009837F0u, 0x000B504F3u, 0x000D744FDu,
    0x001000000u, 0x001306FE1u, 0x0016A09E6u, 0x001AE89FAu, 0x002000000u, 0x00260DFC1u, 0x002D413CDu, 0x0035D13F3u,
    0x004000000u, 0x004C1BF83u, 0x005A8279Au, 0x006BA27E6u, 0x008000000u, 0x009837F05u, 0x00B504F33u, 0x00D744FCDu,
    0x010000000u, 0x01306FE0Au, 0x016A09E66u, 0x01AE89F99u, 0x020000000u, 0x0260DFC14u, 0x02D413CCDu, 0x035D13F33u,
    0x040000000u, 0x04C1BF829u, 0x05A82799Au, 0x06BA27E65u, 0x080000000u, 0x09837F052u, 0x0B504F334u, 0x0D744FCCBu,
};

static inline int qf_i32(int q) {
  if (q < 0) q = 0;
  if (q > 119) q = 119;  // reference throws; callers validate the domain
  return static_cast<int>(kQuantFactor[q]);
}

static inline int qoffset_i32(int q) {
  if (q < 0) q = 0;
  if (q == 0) return 1;
  if (q == 1) return 2;
  return (qf_i32(q) + 1) / 2;
}

static double kQfRecip[120];
static bool init_recip() {
  for (int q = 0; q < 120; ++q) kQfRecip[q] = 1.0 / qf_i32(q);
  return true;
}
static const bool kRecipInit = init_recip();

static inline int c_quant(int value, int q) {  // Quantisation.cpp:69-76
  bool neg = value < 0;
  if (neg) value = -value;
  value <<= 2;
  const int qf = qf_i32(q);
  if (qf > 0) {
    // multiply by reciprocal + exact fix-up: integer divide is the hot-loop
    // cost of the LD trial-quantise search
    int qq = static_cast<int>(static_cast<double>(value) * kQfRecip[q]);
    int r = value - qq * qf;
    if (r < 0) --qq;
    else if (r >= qf) ++qq;
    value = qq;
  } else {
    value /= qf;   // int32-wrapped table entries (q >= 116)
  }
  return neg ? -value : value;
}

static inline int c_scale(int value, int q) {  // Quantisation.cpp:86-95
  bool neg = value < 0;
  if (neg) value = -value;
  value *= qf_i32(q);
  if (value > 0) value += qoffset_i32(q);
  value += 2;
  value /= 4;
  return neg ? -value : value;
}

static inline int adjust_q(int qIndex, int qm) {  // Quantisation.cpp:16-20
  int a = qIndex - qm;
  return a < 0 ? 0 : a;
}

static inline int predict_dc(const int32_t* ll, int llw, int y, int x) {
  if (y > 0 && x > 0) {
    int r = ll[(y - 1) * llw + (x - 1)] + ll[(y - 1) * llw + x] + ll[y * llw + (x - 1)];
    return r >= 0 ? (r + 1) / 3 : (r - 1) / 3;
  }
  if (y > 0) return ll[(y - 1) * llw + x];
  if (x > 0) return ll[y * llw + (x - 1)];
  return 0;
}


static inline int svlc_bits(int32_t v) {
  if (v == 0) return 1;
  uint32_t u = static_cast<uint32_t>(v < 0 ? -v : v) + 1;
  return 2 * (32 - __builtin_clz(u));
}

// Division-free trial sizing tables (the scalar twin of rdo/cbr.py's
// _component_bits_fast): |quant_factor| with the int32-wrap clamp, its bit
// length, and its mantissa normalised to the uint32 top bit.
static uint32_t kAbsQf[120];
static int32_t kBlQf[120];
static uint32_t kQfNorm[120];
static bool init_fastq() {
  for (int q = 0; q < 120; ++q) {
    int32_t w = static_cast<int32_t>(kQuantFactor[q]);
    int64_t a = w < 0 ? -static_cast<int64_t>(w) : static_cast<int64_t>(w);
    if (a > 0x7fffffff) a = 0x7fffffff;
    kAbsQf[q] = static_cast<uint32_t>(a);
    kBlQf[q] = 32 - __builtin_clz(kAbsQf[q]);
    kQfNorm[q] = kAbsQf[q] << (32 - kBlQf[q]);
  }
  return true;
}
static const bool kFastqInit = init_fastq();

namespace {

// LD slice quantiser in serialisation (perm) order: LL lanes first (the
// DC-prediction recurrence against the running reconstructed-LL plane,
// reference Quantisation.cpp:191-234), higher subbands after them in one
// tight independent loop. Trials are bits-only; the final requantise with
// the chosen q stores the plane and leaves the LL state exactly as the
// reference's quantise_transform (EncodeStream.cpp:141-245). Working in
// lane order makes the trailing-zero truncation rule (Slices.cpp:97-113)
// a running count instead of a second perm-order pass, and hoists the
// "is this an LL position" test out of the hot loop.
struct LDLaneQuantiser {
  const int32_t* plane;
  int H, W, ySlices, xSlices, sliceH, sliceW, ts, llw, L, nLL;
  int32_t* qm_lane;    // per-lane quant-matrix value (perm order)
  int32_t* off_block;  // per-lane plane offset within the slice block
  int32_t* lly; int32_t* llx;  // per-LL-lane local LL coords
  int32_t* vals;       // gathered lane values of the current slice
  int32_t* decodedLL;
  int v, h;
  int32_t body_max;    // max |coeff| over the non-LL lanes (current slice)
  int32_t qm_body_max; // max quant-matrix value over the non-LL lanes
  int32_t qm_body_min; // min quant-matrix value over the non-LL lanes

  uint32_t* m4s;       // |coeff|<<2 per body lane (the quant numerator)
  int32_t* blms;       // its bit length
  uint32_t* m4ns;      // its mantissa normalised to the uint32 top bit

  static int scratch_ints(int L_, int sliceH_, int sliceW_, int ts_) {
    return 6 * L_ + 2 * (sliceH_ / ts_) * (sliceW_ / ts_);
  }

  void init(const int32_t* p, int H_, int W_, int ys, int xs, int ts_,
            const int32_t* qm_block, const int32_t* perm, int L_,
            int32_t* dll, int32_t* scratch) {
    plane = p; H = H_; W = W_; ySlices = ys; xSlices = xs; ts = ts_;
    sliceH = H / ys; sliceW = W / xs; llw = W / ts_; L = L_;
    nLL = (sliceH / ts_) * (sliceW / ts_);
    qm_lane = scratch; off_block = scratch + L; vals = scratch + 2 * L;
    m4s = reinterpret_cast<uint32_t*>(scratch + 3 * L);
    blms = scratch + 4 * L;
    m4ns = reinterpret_cast<uint32_t*>(scratch + 5 * L);
    lly = scratch + 6 * L; llx = lly + nLL;
    decodedLL = dll; v = 0; h = 0;
    qm_body_max = 0;
    qm_body_min = 1 << 30;
    for (int k = 0; k < L; ++k) {
      const int by = perm[k] / sliceW, bx = perm[k] % sliceW;
      qm_lane[k] = qm_block[perm[k]];
      off_block[k] = by * W + bx;
      if (k < nLL) { lly[k] = by / ts; llx[k] = bx / ts; }
      else {
        if (qm_lane[k] > qm_body_max) qm_body_max = qm_lane[k];
        if (qm_lane[k] < qm_body_min) qm_body_min = qm_lane[k];
      }
    }
    if (L == nLL) qm_body_min = 0;
  }

  void load_slice() {
    const int32_t* base = plane + v * sliceH * W + h * sliceW;
    int32_t m = 0;
    for (int k = 0; k < nLL; ++k) vals[k] = base[off_block[k]];
    for (int k = nLL; k < L; ++k) {
      const int32_t x = base[off_block[k]];
      vals[k] = x;
      const int32_t a = x < 0 ? -x : x;
      if (a > m) m = a;
      const uint32_t m4 = static_cast<uint32_t>(a) << 2;
      m4s[k] = m4;
      const int bl = m4 ? 32 - __builtin_clz(m4) : 0;
      blms[k] = bl;
      m4ns[k] = bl ? (m4 << (32 - bl)) : 0u;
    }
    body_max = m;
  }

  // Code bit length of body lane k at adjusted quantiser aq, without the
  // division: e+1 = floor(log2(m4/qf))+1 from the bit-length difference
  // plus one normalised-mantissa compare, then a single shift-compare
  // settles whether m+1 is exactly a power of two. Equals
  // svlc_bits(c_quant(vals[k], aq)) for |coeff| < 2^29 (the quantiser's
  // exact domain) — same derivation as rdo/cbr._component_bits_fast.
  inline int body_nb(int k, int aq) const {
    if (aq > 119) aq = 119;   // qf_i32's clamp, so the tables stay in-domain
    const uint32_t m4 = m4s[k];
    const uint32_t qf = kAbsQf[aq];
    if (m4 < qf) return 1;
    const int e1 = blms[k] - kBlQf[aq] + (m4ns[k] >= kQfNorm[aq] ? 1 : 0);
    const bool ok = kBlQf[aq] + e1 <= 32;
    const bool pw = ok && (m4 + qf >= (qf << e1));
    return 2 * (e1 + (pw ? 1 : 0));
  }

  // One LL lane of a probe: always runs (the DC-prediction recurrence
  // state must advance on every trial); returns the code bit length.
  inline int ll_lane(int qIndex, int k, int y0, int x0) {
    const int aq = adjust_q(qIndex, qm_lane[k]);
    const int yLL = y0 + lly[k], xLL = x0 + llx[k];
    const int pred = predict_dc(decodedLL, llw, yLL, xLL);
    const int qv = c_quant(vals[k] - pred, aq);
    decodedLL[yLL * llw + xLL] = c_scale(qv, aq) + pred;
    return svlc_bits(qv);
  }

  void ll_only(int qIndex) {
    const int y0 = v * (sliceH / ts), x0 = h * (sliceW / ts);
    for (int k = 0; k < nLL; ++k) ll_lane(qIndex, k, y0, x0);
  }

  // Smallest |quant_factor| over the body lanes' reachable adjusted
  // indices. kAbsQf is NOT monotone: it rises to the int32 wrap at
  // aq=116 and falls across the wrapped entries 117-119 (the reference's
  // quant_factor overflows int there and our quantiser matches the
  // wrapped arithmetic), so comparing against kAbsQf[aq_min] alone would
  // mis-declare lanes zero whose own (higher, wrapped-smaller) adjusted
  // index still quantises them nonzero. The curve is unimodal, so the
  // minimum over the contiguous clamped range is at an endpoint.
  inline uint32_t body_zero_thr(int qIndex) const {
    int lo = adjust_q(qIndex, qm_body_max);
    int hi = adjust_q(qIndex, qm_body_min);
    if (lo > 119) lo = 119;
    if (hi > 119) hi = 119;
    return kAbsQf[lo] < kAbsQf[hi] ? kAbsQf[lo] : kAbsQf[hi];
  }

  bool body_all_zero(int qIndex) const {
    return static_cast<int64_t>(body_max) * 4 < body_zero_thr(qIndex);
  }

  // Fused probe: LL recurrence + body count with the truncation rule and
  // an exact early exit — the truncated count only ever grows along the
  // scan, so the moment it exceeds ``limit`` the probe cannot fit and
  // returns limit+1 (remaining body lanes are stateless). Equals
  // count_bits_1(trial(...)) when it completes.
  int probe_bits(int qIndex, int limit) {
    const int y0 = v * (sliceH / ts), x0 = h * (sliceW / ts);
    int gross = 0, count = 0;
    for (int k = 0; k < nLL; ++k) {
      const int nb = ll_lane(qIndex, k, y0, x0);
      gross += nb;
      if (nb > 1) count = gross;
    }
    if (count > limit) return limit + 1;
    if (body_all_zero(qIndex)) return count;
    for (int k = nLL; k < L; ++k) {
      const int aq = adjust_q(qIndex, qm_lane[k]);
      const int nb = body_nb(k, aq);
      gross += nb;
      if (nb > 1) {
        count = gross;
        if (count > limit) return limit + 1;
      }
    }
    return count;
  }

  // Trial-quantise the current slice. Fills nb[k] (code bit lengths) and,
  // when out != nullptr, stores the quantised lanes (serialisation order,
  // the slice's row of an (N, L) lane array). Always updates the LL
  // recurrence state.
  void trial(int qIndex, int32_t* out, uint8_t* nb) {
    const int y0 = v * (sliceH / ts), x0 = h * (sliceW / ts);
    for (int k = 0; k < nLL; ++k) {
      const int aq = adjust_q(qIndex, qm_lane[k]);
      const int yLL = y0 + lly[k], xLL = x0 + llx[k];
      const int pred = predict_dc(decodedLL, llw, yLL, xLL);
      const int qv = c_quant(vals[k] - pred, aq);
      decodedLL[yLL * llw + xLL] = c_scale(qv, aq) + pred;
      if (out) out[k] = qv;
      nb[k] = static_cast<uint8_t>(svlc_bits(qv));
    }
    // all-zero-body shortcut: if even the largest coefficient under the
    // smallest reachable |quant_factor| (body_zero_thr handles the wrapped
    // non-monotone entries) rounds to zero, every non-LL lane is a 1-bit
    // zero code — skip the trial-quantise scan entirely
    if (static_cast<int64_t>(body_max) * 4 < body_zero_thr(qIndex)) {
      std::memset(nb + nLL, 1, static_cast<size_t>(L - nLL));
      if (out) std::memset(out + nLL, 0,
                           static_cast<size_t>(L - nLL) * sizeof(int32_t));
      return;
    }
    if (out) {
      for (int k = nLL; k < L; ++k) {
        const int aq = adjust_q(qIndex, qm_lane[k]);
        const int qv = c_quant(vals[k], aq);
        out[k] = qv;
        nb[k] = static_cast<uint8_t>(svlc_bits(qv));
      }
    } else {
      for (int k = nLL; k < L; ++k) {
        const int aq = adjust_q(qIndex, qm_lane[k]);
        nb[k] = static_cast<uint8_t>(svlc_bits(c_quant(vals[k], aq)));
      }
    }
  }

  bool next_slice() {
    if (h < xSlices - 1) { ++h; return true; }
    if (v < ySlices - 1) { h = 0; ++v; return true; }
    return false;
  }
};

// Fused interleaved-chroma probe (the U,V codes interleave per coefficient,
// Slices.cpp:71-95): both LL recurrences always advance; the body scan
// early-exits exactly like probe_bits. Equals
// count_bits_2(trialU, trialV) when it completes.
static int probe_bits_2(LDLaneQuantiser& U, LDLaneQuantiser& V,
                        int qIndex, int limit) {
  const int y0u = U.v * (U.sliceH / U.ts), x0u = U.h * (U.sliceW / U.ts);
  const int y0v = V.v * (V.sliceH / V.ts), x0v = V.h * (V.sliceW / V.ts);
  int gross = 0, count = 0;
  for (int k = 0; k < U.nLL; ++k) {
    int nb = U.ll_lane(qIndex, k, y0u, x0u);
    gross += nb;
    if (nb > 1) count = gross;
    nb = V.ll_lane(qIndex, k, y0v, x0v);
    gross += nb;
    if (nb > 1) count = gross;
  }
  if (count > limit) return limit + 1;
  if (U.body_all_zero(qIndex) && V.body_all_zero(qIndex)) return count;
  for (int k = U.nLL; k < U.L; ++k) {
    int nb = U.body_nb(k, adjust_q(qIndex, U.qm_lane[k]));
    gross += nb;
    if (nb > 1) {
      count = gross;
      if (count > limit) return limit + 1;
    }
    nb = V.body_nb(k, adjust_q(qIndex, V.qm_lane[k]));
    gross += nb;
    if (nb > 1) {
      count = gross;
      if (count > limit) return limit + 1;
    }
  }
  return count;
}

// truncated bit count (Slices.cpp:97-113): gross bits up to the last lane
// with a >1-bit (i.e. non-zero-valued) code
static inline int count_bits_1(const uint8_t* nb, int L) {
  int gross = 0, count = 0;
  for (int k = 0; k < L; ++k) {
    gross += nb[k];
    if (nb[k] > 1) count = gross;
  }
  return count;
}

// chroma variant: u and v codes interleave per coefficient (Slices.cpp:71-95)
static inline int count_bits_2(const uint8_t* nbu, const uint8_t* nbv,
                               int L) {
  int gross = 0, count = 0;
  for (int k = 0; k < L; ++k) {
    gross += nbu[k];
    if (nbu[k] > 1) count = gross;
    gross += nbv[k];
    if (nbv[k] > 1) count = gross;
  }
  return count;
}

static int intlog2_c(int value) {  // Utils.cpp:40-48
  int log = 0;
  --value;
  while (value > 0) { value >>= 1; ++log; }
  return log;
}

}  // namespace

// LD rate control + final quantisation in one pass (the final requantise of
// each slice, with the chosen q, leaves the DC-prediction state exactly as
// quantise_transform would — reference EncodeStream.cpp:195-245).
// band-of-position maps are slice-block row-major quant-matrix values.
// Returns 0 on success.
EXPORT int ld_encode(const int32_t* yp, const int32_t* up, const int32_t* vp,
                     int64_t H, int64_t W, int64_t CH, int64_t CW,
                     int64_t ySlices, int64_t xSlices, int64_t ts,
                     const int32_t* qm_block_y,   // (H/ySlices)*(W/xSlices)
                     const int32_t* qm_block_c,   // (CH/ySlices)*(CW/xSlices)
                     const int32_t* perm_y, int64_t Ly,
                     const int32_t* perm_c, int64_t Lc,
                     const int32_t* slice_bytes,  // N
                     int32_t* q_out,              // N
                     int32_t* qy_out,             // (N, Ly) lanes, perm order
                     int32_t* qu_out, int32_t* qv_out) {  // (N, Lc) each
  const int64_t N = ySlices * xSlices;
  int32_t* dll_y = new int32_t[(H / ts) * (W / ts)]();
  int32_t* dll_u = new int32_t[(CH / ts) * (CW / ts)]();
  int32_t* dll_v = new int32_t[(CH / ts) * (CW / ts)]();
  const int sy_h = H / ySlices, sy_w = W / xSlices;
  const int sc_h = CH / ySlices, sc_w = CW / xSlices;
  int32_t* scr_y = new int32_t[LDLaneQuantiser::scratch_ints(Ly, sy_h, sy_w, ts)];
  int32_t* scr_u = new int32_t[LDLaneQuantiser::scratch_ints(Lc, sc_h, sc_w, ts)];
  int32_t* scr_v = new int32_t[LDLaneQuantiser::scratch_ints(Lc, sc_h, sc_w, ts)];
  uint8_t* nb_y = new uint8_t[Ly];
  uint8_t* nb_u = new uint8_t[Lc];
  uint8_t* nb_v = new uint8_t[Lc];
  LDLaneQuantiser qy, qu, qv;
  qy.init(yp, H, W, ySlices, xSlices, ts, qm_block_y, perm_y, Ly, dll_y, scr_y);
  qu.init(up, CH, CW, ySlices, xSlices, ts, qm_block_c, perm_c, Lc, dll_u, scr_u);
  qv.init(vp, CH, CW, ySlices, xSlices, ts, qm_block_c, perm_c, Lc, dll_v, scr_v);
  for (int64_t i = 0; i < N; ++i) {
    qy.load_slice();
    qu.load_slice();
    qv.load_slice();
    const int bytes = slice_bytes[i];
    const int length_bits = intlog2_c(8 * bytes - 7);
    const int bits_available = 8 * bytes - 7 - length_bits;
    int trialQ = 63, q = 127, delta = 64;
    while (delta > 0) {
      delta >>= 1;
      // fused probes: division-free body sizing with exact early exit;
      // when luma alone overruns, the chroma body scans are skipped
      // entirely (their LL recurrences still advance)
      int bits = qy.probe_bits(trialQ, bits_available);
      if (bits <= bits_available) {
        bits += probe_bits_2(qu, qv, trialQ, bits_available - bits);
      } else {
        qu.ll_only(trialQ);
        qv.ll_only(trialQ);
      }
      if (bits <= bits_available) {
        if (trialQ < q) q = trialQ;
        trialQ -= delta;
      } else {
        trialQ += delta;
      }
    }
    qy.trial(q, qy_out + i * Ly, nb_y);
    qu.trial(q, qu_out + i * Lc, nb_u);
    qv.trial(q, qv_out + i * Lc, nb_v);
    q_out[i] = q;
    qy.next_slice();
    qu.next_slice();
    qv.next_slice();
  }
  delete[] dll_y; delete[] dll_u; delete[] dll_v;
  delete[] scr_y; delete[] scr_u; delete[] scr_v;
  delete[] nb_y; delete[] nb_u; delete[] nb_v;
  return 0;
}

// Inverse-quantise a full plane in transform order with LL DC prediction
// (reference inverse_quantise_LLSubband + inverse_quantise_subbands,
// Quantisation.cpp:287-353). qm_block is the slice-block quant-matrix map.
EXPORT void ld_dequantise_plane(const int32_t* qplane, int64_t H, int64_t W,
                                int64_t ySlices, int64_t xSlices, int64_t ts,
                                const int32_t* qm_block, const int32_t* q_idx,
                                int32_t* out) {
  const int64_t sliceH = H / ySlices, sliceW = W / xSlices;
  const int64_t llh = H / ts, llw = W / ts;
  int32_t* ll = new int32_t[llh * llw];
  // LL subband first, sequential raster with prediction
  for (int64_t y = 0; y < llh; ++y) {
    for (int64_t x = 0; x < llw; ++x) {
      const int64_t yb = ((y + 1) * ySlices - 1) / llh;
      const int64_t xb = ((x + 1) * xSlices - 1) / llw;
      const int64_t yy = y * ts, xx = x * ts;
      const int aq = adjust_q(q_idx[yb * xSlices + xb],
                              qm_block[(yy % sliceH) * sliceW + (xx % sliceW)]);
      const int pred = predict_dc(ll, llw, y, x);
      ll[y * llw + x] = c_scale(qplane[yy * W + xx], aq) + pred;
    }
  }
  for (int64_t y = 0; y < H; ++y) {
    for (int64_t x = 0; x < W; ++x) {
      if ((y % ts) == 0 && (x % ts) == 0) {
        out[y * W + x] = ll[(y / ts) * llw + (x / ts)];
      } else {
        const int64_t yb = y / sliceH, xb = x / sliceW;
        const int aq = adjust_q(q_idx[yb * xSlices + xb],
                                qm_block[(y % sliceH) * sliceW + (x % sliceW)]);
        out[y * W + x] = c_scale(qplane[y * W + x], aq);
      }
    }
  }
  delete[] ll;
}

// Compute, for S streams of n_lanes quantised coefficients, the "bits used"
// count with the trailing-zero truncation rule (reference Slices.cpp:97-119):
// gross bit count up to and including the last non-zero coefficient.
EXPORT void component_bits_used(const int32_t* lanes, int64_t S, int64_t n_lanes,
                                int32_t* out) {
  for (int64_t s = 0; s < S; ++s) {
    const int32_t* row = lanes + s * n_lanes;
    int64_t gross = 0, count = 0;
    for (int64_t i = 0; i < n_lanes; ++i) {
      int32_t v = row[i];
      if (v == 0) { gross += 1; continue; }
      uint32_t u = static_cast<uint32_t>(v < 0 ? -v : v) + 1;
      int k = 32 - __builtin_clz(u);
      gross += 2 * k;
      count = gross;
    }
    out[s] = static_cast<int32_t>(count);
  }
}

// ---------------------------------------------------- host synthesis tail
// Host decode route: when fetching the decoded samples from the device takes
// longer than one CPU core's synthesis, the decoder's auto route sends
// the synthesis tail (dequant + inverse DWT + clip + planar format) to these
// functions instead of fetching 5.5 MB/frame of decoded samples. Bit-exact
// twin of the device path (pipeline/decoder.py) and of the reference tail
// (/root/reference/src/DecodeStream/DecodeStream.cpp:551-609).
//
// The inverse DWT is a generic lifting-ladder engine driven by the SAME step
// tables as vc2tpu.wavelet.lifting._STEPS (the Python side passes the
// already-inverted ladder: reversed steps, flipped signs). Edge handling is
// index clamping to [0, n-1] in parity space, as the reference's clamped
// taps (WaveletTransform.cpp:495-498).

// One lifting step applied to contiguous parity arrays tgt[n_t] from
// src[n_src]: tgt[i] += sign * ((sum_k coeff_k * src[clamp(i+off_k)] + add)
// >> shift). Interior (no clamping needed) is a plain vectorisable loop.
template <int NT>
static inline void step_rows_1d(int32_t* tgt, const int32_t* src,
                                int64_t n_t, int64_t n_src,
                                const int32_t* offs, const int32_t* coeffs,
                                int sign, int add, int shift) {
  int64_t lo = 0, hi = 0;
  for (int k = 0; k < NT; ++k) {
    if (offs[k] < lo) lo = offs[k];
    if (offs[k] > hi) hi = offs[k];
  }
  const int64_t i0 = -lo;                      // first interior index
  const int64_t i1 = n_src - hi < n_t ? (n_src - hi > 0 ? n_src - hi : 0)
                                      : n_t;   // one past last interior
  for (int64_t i = 0; i < (i0 < n_t ? i0 : n_t); ++i) {
    int32_t a = add;
    for (int k = 0; k < NT; ++k) {
      int64_t j = i + offs[k];
      if (j < 0) j = 0; else if (j >= n_src) j = n_src - 1;
      a += coeffs[k] * src[j];
    }
    tgt[i] += sign * (a >> shift);
  }
  for (int64_t i = i0; i < i1; ++i) {
    int32_t a = add;
    for (int k = 0; k < NT; ++k) a += coeffs[k] * src[i + offs[k]];
    tgt[i] += sign * (a >> shift);
  }
  for (int64_t i = (i1 > i0 ? i1 : i0); i < n_t; ++i) {
    int32_t a = add;
    for (int k = 0; k < NT; ++k) {
      int64_t j = i + offs[k];
      if (j < 0) j = 0; else if (j >= n_src) j = n_src - 1;
      a += coeffs[k] * src[j];
    }
    tgt[i] += sign * (a >> shift);
  }
}

static void step_1d(int32_t* tgt, const int32_t* src, int64_t n_t,
                    int64_t n_src, int ntaps, const int32_t* offs,
                    const int32_t* coeffs, int sign, int add, int shift) {
  switch (ntaps) {
    case 1: step_rows_1d<1>(tgt, src, n_t, n_src, offs, coeffs, sign, add, shift); break;
    case 2: step_rows_1d<2>(tgt, src, n_t, n_src, offs, coeffs, sign, add, shift); break;
    case 4: step_rows_1d<4>(tgt, src, n_t, n_src, offs, coeffs, sign, add, shift); break;
    case 8: step_rows_1d<8>(tgt, src, n_t, n_src, offs, coeffs, sign, add, shift); break;
    default:
      for (int64_t i = 0; i < n_t; ++i) {
        int32_t a = add;
        for (int k = 0; k < ntaps; ++k) {
          int64_t j = i + offs[k];
          if (j < 0) j = 0; else if (j >= n_src) j = n_src - 1;
          a += coeffs[k] * src[j];
        }
        tgt[i] += sign * (a >> shift);
      }
  }
}

// Vertical variant: parity "arrays" are rows of the sub-lattice (elements at
// stride es within the row); tap source rows clamp per row, the inner x loop
// is contiguous for es == 1.
template <int NT>
static inline void step_rows_vert(int32_t* base, int64_t row_pitch,
                                  int64_t t_parity, int64_t n_t, int64_t n_src,
                                  int64_t wlen, int64_t es,
                                  const int32_t* offs, const int32_t* coeffs,
                                  int sign, int add, int shift) {
  const int32_t* srow[NT];
  for (int64_t i = 0; i < n_t; ++i) {
    int32_t* tgt = base + (2 * i + t_parity) * row_pitch;
    for (int k = 0; k < NT; ++k) {
      int64_t j = i + offs[k];
      if (j < 0) j = 0; else if (j >= n_src) j = n_src - 1;
      srow[k] = base + (2 * j + (1 - t_parity)) * row_pitch;
    }
    if (es == 1) {
      for (int64_t x = 0; x < wlen; ++x) {
        int32_t a = add;
        for (int k = 0; k < NT; ++k) a += coeffs[k] * srow[k][x];
        tgt[x] += sign * (a >> shift);
      }
    } else {
      for (int64_t x = 0; x < wlen; ++x) {
        int32_t a = add;
        for (int k = 0; k < NT; ++k) a += coeffs[k] * srow[k][x * es];
        tgt[x * es] += sign * (a >> shift);
      }
    }
  }
}

static void step_vert(int32_t* base, int64_t row_pitch, int64_t t_parity,
                      int64_t n_t, int64_t n_src, int64_t wlen, int64_t es,
                      int ntaps, const int32_t* offs, const int32_t* coeffs,
                      int sign, int add, int shift) {
  switch (ntaps) {
    case 1: step_rows_vert<1>(base, row_pitch, t_parity, n_t, n_src, wlen, es, offs, coeffs, sign, add, shift); break;
    case 2: step_rows_vert<2>(base, row_pitch, t_parity, n_t, n_src, wlen, es, offs, coeffs, sign, add, shift); break;
    case 4: step_rows_vert<4>(base, row_pitch, t_parity, n_t, n_src, wlen, es, offs, coeffs, sign, add, shift); break;
    case 8: step_rows_vert<8>(base, row_pitch, t_parity, n_t, n_src, wlen, es, offs, coeffs, sign, add, shift); break;
    default: break;  // tap counts are 1/2/4/8 in every VC-2 kernel
  }
}

// Parsed lifting step (one predict/update pass of a ladder).
struct StepDef {
  int t, sign, add, shift, nt;
  int32_t offs[8], coeffs[8];
  int lo, hi;                       // tap offset reach in parity-row space
};

static void parse_steps(const int32_t* meta, const int32_t* taps,
                        int64_t n_steps, StepDef* st) {
  const int32_t* tp = taps;
  for (int64_t k = 0; k < n_steps; ++k) {
    const int32_t* m = meta + k * 5;
    st[k].t = m[0]; st[k].sign = m[1]; st[k].add = m[2];
    st[k].shift = m[3]; st[k].nt = m[4];
    st[k].lo = 0; st[k].hi = 0;
    for (int j = 0; j < st[k].nt; ++j) {
      st[k].offs[j] = tp[2 * j]; st[k].coeffs[j] = tp[2 * j + 1];
      if (st[k].offs[j] < st[k].lo) st[k].lo = st[k].offs[j];
      if (st[k].offs[j] > st[k].hi) st[k].hi = st[k].offs[j];
    }
    tp += 2 * st[k].nt;
  }
}

// Wavefront row lags for running every vertical step of a ladder in ONE
// sweep down the plane (step k processes target row m - L[k] at outer index
// m). Sequential-pass semantics are preserved by ordering each pair of
// steps around their data hazards, in target-parity row space:
//   RAW  (k reads the parity k' writes):  L_k >= L_k' + max(hi_k, 0) + 1
//   WAR  (k writes the parity k' reads):  L_k >= L_k' + max(-lo_k', 0) + 1
//   WAW  (same target parity):            L_k >= L_k' + 1
// Edge-clamped taps stay safe: a high clamp to the last source row only
// happens for targets within hi of the end, which the lag already orders
// after that source row's final update.
static void vertical_lags(const StepDef* st, int64_t n_steps, int64_t base,
                          int64_t* L) {
  for (int64_t k = 0; k < n_steps; ++k) {
    int64_t l = base;               // lag vs the pre-ladder row state
    for (int64_t p = 0; p < k; ++p) {
      int64_t c;
      if (st[p].t != st[k].t) {
        int64_t raw = L[p] + (st[k].hi > 0 ? st[k].hi : 0) + 1;
        int64_t war = L[p] + (st[p].lo < 0 ? -st[p].lo : 0) + 1;
        c = raw > war ? raw : war;
      } else {
        c = L[p] + 1;
      }
      if (c > l) l = c;
    }
    L[k] = l;
  }
}

// One vertical lifting step applied to ONE target row (index i in the
// target-parity sub-lattice) — the single-row body of step_rows_vert.
template <int NT>
static inline void vert_row(int32_t* base, int64_t row_pitch, const StepDef& S,
                            int64_t i, int64_t n_src, int64_t wlen,
                            int64_t es) {
  const int32_t* srow[NT];
  int32_t* tgt = base + (2 * i + S.t) * row_pitch;
  for (int k = 0; k < NT; ++k) {
    int64_t j = i + S.offs[k];
    if (j < 0) j = 0; else if (j >= n_src) j = n_src - 1;
    srow[k] = base + (2 * j + (1 - S.t)) * row_pitch;
  }
  const int sign = S.sign, add = S.add, shift = S.shift;
  if (es == 1) {
#pragma GCC ivdep
    for (int64_t x = 0; x < wlen; ++x) {
      int32_t a = add;
      for (int k = 0; k < NT; ++k) a += S.coeffs[k] * srow[k][x];
      tgt[x] += sign * (a >> shift);
    }
  } else {
    for (int64_t x = 0; x < wlen; ++x) {
      int32_t a = add;
      for (int k = 0; k < NT; ++k) a += S.coeffs[k] * srow[k][x * es];
      tgt[x * es] += sign * (a >> shift);
    }
  }
}

static inline void vert_row_n(int32_t* base, int64_t row_pitch,
                              const StepDef& S, int64_t i, int64_t n_src,
                              int64_t wlen, int64_t es) {
  switch (S.nt) {
    case 1: vert_row<1>(base, row_pitch, S, i, n_src, wlen, es); break;
    case 2: vert_row<2>(base, row_pitch, S, i, n_src, wlen, es); break;
    case 4: vert_row<4>(base, row_pitch, S, i, n_src, wlen, es); break;
    case 8: vert_row<8>(base, row_pitch, S, i, n_src, wlen, es); break;
    default: break;  // tap counts are 1/2/4/8 in every VC-2 kernel
  }
}

// Full horizontal ladder on ONE physical row: deinterleave the parity
// halves into contiguous scratch (applying the accuracy shift-in for the
// forward transform), run the steps, apply the rounded shift-out for the
// inverse, interleave back.
static void horiz_row(int32_t* row, int64_t s, int64_t ws, const StepDef* st,
                      int64_t n_steps, int32_t* tmp, int64_t shift_out,
                      int64_t shift_in) {
  const int64_t ne_c = (ws + 1) / 2, no_c = ws / 2;
  int32_t* e = tmp;
  int32_t* o = tmp + ne_c;
  if (shift_in) {
    if (s == 1) {
      for (int64_t i = 0; i < no_c; ++i) {
        e[i] = row[2 * i] << shift_in; o[i] = row[2 * i + 1] << shift_in;
      }
      if (ws & 1) e[ne_c - 1] = row[ws - 1] << shift_in;
    } else {
      for (int64_t i = 0; i < no_c; ++i) {
        e[i] = row[2 * i * s] << shift_in;
        o[i] = row[(2 * i + 1) * s] << shift_in;
      }
      if (ws & 1) e[ne_c - 1] = row[(ws - 1) * s] << shift_in;
    }
  } else if (s == 1) {
    for (int64_t i = 0; i < no_c; ++i) { e[i] = row[2 * i]; o[i] = row[2 * i + 1]; }
    if (ws & 1) e[ne_c - 1] = row[ws - 1];
  } else {
    for (int64_t i = 0; i < no_c; ++i) { e[i] = row[2 * i * s]; o[i] = row[(2 * i + 1) * s]; }
    if (ws & 1) e[ne_c - 1] = row[(ws - 1) * s];
  }
  for (int64_t k = 0; k < n_steps; ++k) {
    const StepDef& S = st[k];
    if (S.t) step_1d(o, e, no_c, ne_c, S.nt, S.offs, S.coeffs, S.sign, S.add, S.shift);
    else     step_1d(e, o, ne_c, no_c, S.nt, S.offs, S.coeffs, S.sign, S.add, S.shift);
  }
  if (shift_out) {
    const int32_t half = 1 << (shift_out - 1);
    for (int64_t i = 0; i < ne_c; ++i) e[i] = (e[i] + half) >> shift_out;
    for (int64_t i = 0; i < no_c; ++i) o[i] = (o[i] + half) >> shift_out;
  }
  if (s == 1) {
    for (int64_t i = 0; i < no_c; ++i) { row[2 * i] = e[i]; row[2 * i + 1] = o[i]; }
    if (ws & 1) row[ws - 1] = e[ne_c - 1];
  } else {
    for (int64_t i = 0; i < no_c; ++i) { row[2 * i * s] = e[i]; row[(2 * i + 1) * s] = o[i]; }
    if (ws & 1) row[(ws - 1) * s] = e[ne_c - 1];
  }
}

// Inverse DWT over an in-place transform-layout plane. ``meta``/``taps``
// encode the ALREADY-INVERTED ladder (reversed order, flipped sign):
// meta[s*5..] = {target parity (0=e,1=o), sign, add, shift, ntaps};
// taps = concatenated (offset, coeff) pairs. ``shift_out`` is the kernel
// accuracy shift removed per level: v = (v + (1 << (shift-1))) >> shift.
EXPORT void idwt_plane(int32_t* plane, int64_t H, int64_t W, int64_t depth,
                       const int32_t* meta, const int32_t* taps,
                       int64_t n_steps, int64_t shift_out) {
  // scratch for horizontal deinterleave (one row's parity halves)
  static thread_local int32_t* tmp = nullptr;
  static thread_local int64_t tmp_cap = 0;
  if (tmp_cap < W + 16) {
    delete[] tmp;
    tmp_cap = W + 16;
    tmp = new int32_t[tmp_cap];
  }
  StepDef st[16];
  parse_steps(meta, taps, n_steps, st);
  for (int64_t level = depth - 1; level >= 0; --level) {
    const int64_t s = int64_t(1) << level;
    const int64_t hs = H >> level, ws = W >> level;
    const int64_t row_pitch = s * W;
    const int64_t ne_r = (hs + 1) / 2, no_r = hs / 2;
    // vertical passes (separate sweeps measure as fast as a fused wavefront
    // here — the inverse is compute-bound on this ladder order; the forward
    // in dwt_plane below is the one that wins from fusion)
    for (int64_t k = 0; k < n_steps; ++k)
      step_vert(plane, row_pitch, st[k].t, st[k].t ? no_r : ne_r,
                st[k].t ? ne_r : no_r, ws, s, st[k].nt, st[k].offs,
                st[k].coeffs, st[k].sign, st[k].add, st[k].shift);
    // horizontal: deinterleave each sub-lattice row once, run the whole
    // ladder on contiguous halves, apply shift-out, interleave back
    for (int64_t r = 0; r < hs; ++r)
      horiz_row(plane + r * row_pitch, s, ws, st, n_steps, tmp, shift_out, 0);
  }
}

// Inverse-quantise entropy-decoded slice lanes straight into the in-place
// transform-layout plane. Lanes are band-contiguous (slices/layout
// .lane_order); ``off_plane`` maps lane k to its row-major offset inside the
// slice block pre-scaled to plane coordinates, ``qm_lane`` is the per-lane
// quant-matrix value. Flat over lanes with precomputed factor/offset LUTs —
// slices are tiny (2x2 is the production geometry) so per-band inner loops
// would drown in loop overhead.
static int32_t kQfLut[120], kQoLut[120];
static bool init_qlut() {
  for (int q = 0; q < 120; ++q) { kQfLut[q] = qf_i32(q); kQoLut[q] = qoffset_i32(q); }
  return true;
}
static const bool kQlutInit = init_qlut();

template <int LFIX>
static void dequant_scatter_impl(const int16_t* lanes, int64_t S, int64_t L,
                                 const int32_t* q_idx,
                                 const int32_t* qm_lane,
                                 const int32_t* off_plane,
                                 int64_t xs, int64_t sh, int64_t sw,
                                 int64_t W, int32_t* plane) {
  const int64_t Lr = LFIX ? LFIX : L;
  const int16_t* lv = lanes;
  const int32_t* qp = q_idx;
  for (int64_t sy = 0; sy < S / xs; ++sy) {
    int32_t* row_base = plane + sy * sh * W;
    for (int64_t sx = 0; sx < xs; ++sx, lv += Lr) {
      int32_t* base = row_base + sx * sw;
      const int q = *qp++;
      for (int64_t k = 0; k < Lr; ++k) {
        int aq = q - qm_lane[k];
        if (aq < 0) aq = 0; else if (aq > 119) aq = 119;
        int32_t v = lv[k];
        const int32_t neg = v >> 31;          // branchless |v| and re-sign
        v = (v ^ neg) - neg;
        v *= kQfLut[aq];
        v += kQoLut[aq] & -static_cast<int32_t>(v > 0);  // += qo iff v > 0
        v += 2;
        v = v < 0 ? -((-v) >> 2) : v >> 2;    // trunc /4 even after int32 wrap
        base[off_plane[k]] = (v ^ neg) - neg;
      }
    }
  }
}

EXPORT void hq_dequant_scatter(const int16_t* lanes, int64_t S, int64_t L,
                               const int32_t* q_idx, const int32_t* qm_lane,
                               const int32_t* off_plane,
                               int64_t xs, int64_t sh, int64_t sw, int64_t W,
                               int32_t* plane) {
  // production geometries use tiny slices; a compile-time lane count lets
  // the compiler fully unroll the inner loop
  switch (L) {
    case 2: dequant_scatter_impl<2>(lanes, S, L, q_idx, qm_lane, off_plane, xs, sh, sw, W, plane); break;
    case 4: dequant_scatter_impl<4>(lanes, S, L, q_idx, qm_lane, off_plane, xs, sh, sw, W, plane); break;
    case 8: dequant_scatter_impl<8>(lanes, S, L, q_idx, qm_lane, off_plane, xs, sh, sw, W, plane); break;
    case 16: dequant_scatter_impl<16>(lanes, S, L, q_idx, qm_lane, off_plane, xs, sh, sw, W, plane); break;
    default: dequant_scatter_impl<0>(lanes, S, L, q_idx, qm_lane, off_plane, xs, sh, sw, W, plane);
  }
}

// Clip to signal range, add the offset-binary zero point and emit the wire
// format: uint8 for 8-bit video, MSB-justified big-endian uint16 otherwise
// (reference src/Library/src/Arrays.cpp:381-426 word formatting).
EXPORT void clip_format_out(const int32_t* plane, int64_t W,
                            int64_t out_h, int64_t out_w, int64_t bitdepth,
                            uint8_t* out) {
  const int32_t zero = 1 << (bitdepth - 1);
  if (bitdepth <= 8) {
    uint8_t* o = out;
    for (int64_t y = 0; y < out_h; ++y) {
      const int32_t* r = plane + y * W;
      for (int64_t x = 0; x < out_w; ++x) {
        int32_t v = r[x];
        if (v < -zero) v = -zero; else if (v > zero - 1) v = zero - 1;
        *o++ = static_cast<uint8_t>(v + zero);
      }
    }
  } else {
    const int just = 16 - bitdepth;
    uint16_t* o = reinterpret_cast<uint16_t*>(out);
    for (int64_t y = 0; y < out_h; ++y) {
      const int32_t* r = plane + y * W;
      for (int64_t x = 0; x < out_w; ++x) {
        int32_t v = r[x];
        if (v < -zero) v = -zero; else if (v > zero - 1) v = zero - 1;
        const uint16_t u = static_cast<uint16_t>((v + zero) << just);
        *o++ = static_cast<uint16_t>((u << 8) | (u >> 8));
      }
    }
  }
}

// ------------------------------------------------- native LD slice packing
// Assemble the complete LD payload (reference LDSliceIO, Slices.cpp:195-303)
// in one pass: per slice a 7-bit qIndex, an intlog2(8*size-7)-bit
// luma-length field, the bounded luma exp-Golomb region, then the remaining
// bits as the bounded interleaved-U,V region (zero-filled to the slice end —
// the output buffer arrives zeroed). Bounded writes drop code tails at the
// region end exactly as the reference's bounded stream (VLC.cpp:151-155;
// the dropped bits are the all-1 tails of trailing zero codes).

static inline void put_bits(uint8_t* buf, int64_t& pos, uint64_t code,
                            int nb) {
  while (nb > 0) {
    const int avail = 8 - static_cast<int>(pos & 7);
    const int take = nb < avail ? nb : avail;
    const uint8_t bits =
        static_cast<uint8_t>((code >> (nb - take)) & ((1u << take) - 1));
    buf[pos >> 3] |= static_cast<uint8_t>(bits << (avail - take));
    pos += take;
    nb -= take;
  }
}

static inline void put_bits_bounded(uint8_t* buf, int64_t& pos,
                                    int64_t bound_end, uint64_t code,
                                    int nb) {
  if (pos >= bound_end) { pos += nb; return; }
  if (pos + nb > bound_end) {
    const int keep = static_cast<int>(bound_end - pos);
    put_bits(buf, pos, code >> (nb - keep), keep);
    pos = bound_end;
    return;
  }
  put_bits(buf, pos, code, nb);
}

static inline uint64_t svlc_code(int32_t v, int* nb) {
  if (v == 0) { *nb = 1; return 1; }
  uint32_t u = static_cast<uint32_t>(v < 0 ? -v : v) + 1;
  const int k = 32 - __builtin_clz(u);
  uint64_t bits = 0;
  for (int j = k - 2; j >= 0; --j) {
    bits <<= 2;
    if ((u >> j) & 1) bits |= 1;
  }
  bits = (bits << 1) | 1;
  bits = (bits << 1) | (v < 0 ? 1 : 0);
  *nb = 2 * k;
  return bits;
}

// Returns 1 if any slice's interleaved U,V data cannot fit its region
// ("Too many bytes for the U and V slices"), else 0.
EXPORT int ld_pack(const int32_t* q_idx, const int32_t* ly,
                   const int32_t* lu, const int32_t* lv,
                   int64_t n, int64_t Ly, int64_t Lc,
                   const int64_t* sizes, uint8_t* out) {
  int64_t start_bit = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t size = sizes[i];
    const int64_t total_bits = 8 * size;
    const int len_bits = intlog2_c(static_cast<int>(total_bits - 7));
    const int32_t* y = ly + i * Ly;
    const int32_t* u = lu + i * Lc;
    const int32_t* v = lv + i * Lc;
    // truncated luma bit count (Slices.cpp:51-69)
    int64_t gross = 0, y_bits = 0;
    for (int64_t k = 0; k < Ly; ++k) {
      const int nb = svlc_bits(y[k]);
      gross += nb;
      if (nb > 1) y_bits = gross;
    }
    // truncated interleaved chroma bit count (Slices.cpp:71-95)
    int64_t uv_need = 0;
    gross = 0;
    for (int64_t k = 0; k < Lc; ++k) {
      int nb = svlc_bits(u[k]);
      gross += nb;
      if (nb > 1) uv_need = gross;
      nb = svlc_bits(v[k]);
      gross += nb;
      if (nb > 1) uv_need = gross;
    }
    const int64_t uv_bits = total_bits - 7 - len_bits - y_bits;
    if (uv_need > uv_bits) return 1;
    int64_t pos = start_bit;
    put_bits(out, pos, static_cast<uint64_t>(q_idx[i]) & 0x7F, 7);
    put_bits(out, pos, static_cast<uint64_t>(y_bits), len_bits);
    int64_t bound = pos + y_bits;
    for (int64_t k = 0; k < Ly && pos < bound; ++k) {
      int nb;
      const uint64_t code = svlc_code(y[k], &nb);
      put_bits_bounded(out, pos, bound, code, nb);
    }
    pos = bound;
    bound = pos + uv_bits;
    for (int64_t k = 0; k < Lc && pos < bound; ++k) {
      int nb;
      uint64_t code = svlc_code(u[k], &nb);
      put_bits_bounded(out, pos, bound, code, nb);
      code = svlc_code(v[k], &nb);
      put_bits_bounded(out, pos, bound, code, nb);
    }
    start_bit += total_bits;
  }
  return 0;
}

// ------------------------------------------------- native forward DWT
// Forward twin of idwt_plane: per level shift-in, horizontal ladder, then
// vertical ladder (reference waveletTransform, WaveletTransform.cpp:262-281
// over the per-kernel forward ladders). ``meta``/``taps`` encode the FORWARD
// steps verbatim from wavelet.lifting._STEPS. Used by the ConstQ and LD
// host encode routes (the analysis transform runs where the coefficients
// are consumed when the device transfers cost more than one core's DWT).
//
// The whole level runs as ONE wavefront sweep down the plane: the
// horizontal ladder leads (completing physical rows 2m and 2m+1 at outer
// index m) and every vertical step trails it at its hazard lag
// (vertical_lags above), so each row is read into cache and written back
// once per level instead of once per pass. Bit-identical to the separate
// sweeps — the lags reproduce sequential-pass semantics exactly — and
// measured 1.2-1.4x at 1080p, 1.9x at 4K (BASELINE.md round-3 host
// profile); the inverse keeps separate sweeps, which measure equal there.
EXPORT void dwt_plane(int32_t* plane, int64_t H, int64_t W, int64_t depth,
                      const int32_t* meta, const int32_t* taps,
                      int64_t n_steps, int64_t shift_in) {
  static thread_local int32_t* tmp = nullptr;
  static thread_local int64_t tmp_cap = 0;
  if (tmp_cap < W + 16) {
    delete[] tmp;
    tmp_cap = W + 16;
    tmp = new int32_t[tmp_cap];
  }
  StepDef st[16];
  parse_steps(meta, taps, n_steps, st);
  // every vertical step reads rows the horizontal head must have finished:
  // lag the first by the ladder's forward reach, the rest by their hazards
  int64_t base = 1;
  for (int64_t k = 0; k < n_steps; ++k)
    if (st[k].hi + 1 > base) base = st[k].hi + 1;
  int64_t L[16];
  vertical_lags(st, n_steps, base, L);
  int64_t Lmax = 0;
  for (int64_t k = 0; k < n_steps; ++k) if (L[k] > Lmax) Lmax = L[k];
  for (int64_t level = 0; level < depth; ++level) {
    const int64_t s = int64_t(1) << level;
    const int64_t hs = H >> level, ws = W >> level;
    const int64_t row_pitch = s * W;
    const int64_t ne_r = (hs + 1) / 2, no_r = hs / 2;
    const int64_t m_end = ne_r + Lmax + 1;
    for (int64_t m = 0; m < m_end; ++m) {
      const int64_t r0 = 2 * m;
      for (int64_t r = r0; r <= r0 + 1 && r < hs; ++r)
        horiz_row(plane + r * row_pitch, s, ws, st, n_steps, tmp, 0,
                  shift_in);
      for (int64_t k = 0; k < n_steps; ++k) {
        const int64_t i = m - L[k];
        if (i >= 0 && i < (st[k].t ? no_r : ne_r))
          vert_row_n(plane, row_pitch, st[k], i, st[k].t ? ne_r : no_r,
                     ws, s);
      }
    }
  }
}

// Forward twin of hq_dequant_scatter: gather each slice's coefficients from
// the in-place transform-layout plane in serialisation (perm) order and
// dead-zone quantise them (Quantisation.cpp:69-76) — the HQ ConstQ encode
// analysis stage for the host route (no rate-control search, so one core
// can beat shipping the frame to the device).
EXPORT void hq_quant_gather(const int32_t* plane, int64_t S, int64_t L,
                            const int32_t* q_idx, const int32_t* qm_lane,
                            const int32_t* off_plane,
                            int64_t xs, int64_t sh, int64_t sw, int64_t W,
                            int32_t* lanes) {
  for (int64_t si = 0; si < S; ++si) {
    const int32_t* base = plane + (si / xs) * sh * W + (si % xs) * sw;
    int32_t* lv = lanes + si * L;
    const int q = q_idx[si];
    for (int64_t k = 0; k < L; ++k) {
      int aq = q - qm_lane[k];
      if (aq < 0) aq = 0; else if (aq > 119) aq = 119;
      lv[k] = c_quant(base[off_plane[k]], aq);
    }
  }
}

// Native HQ slice payload writer (the write half of slices/hq.py
// encode_hq_slices; sizing/validation stays in the caller). Wire format per
// slice (reference Slices.cpp:305-467): ``prefix`` zero bytes, 1-byte
// qIndex, then per component {1-byte length/scalar, bounded exp-Golomb
// data, byte-align}. ``out`` arrives zeroed; codes cut at their region
// bound lose only the all-1 tails of trailing zero codes.
EXPORT void hq_pack_write(const int32_t* q_idx,
                          const int32_t* ly, const int32_t* lu,
                          const int32_t* lv,
                          int64_t n, int64_t Ly, int64_t Lc,
                          int64_t prefix, int64_t scalar,
                          const int64_t* yb, const int64_t* ub,
                          const int64_t* vb, const int64_t* starts,
                          uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = starts[i] + prefix;
    out[p] = static_cast<uint8_t>(q_idx[i]);
    const int32_t* comps[3] = {ly + i * Ly, lu + i * Lc, lv + i * Lc};
    const int64_t Ls[3] = {Ly, Lc, Lc};
    const int64_t cb[3] = {yb[i], ub[i], vb[i]};
    ++p;
    for (int c = 0; c < 3; ++c) {
      out[p] = static_cast<uint8_t>(cb[c] / scalar);
      ++p;
      int64_t bit = p * 8;
      const int64_t bound = bit + cb[c] * 8;
      const int32_t* lanes = comps[c];
      for (int64_t k = 0; k < Ls[c] && bit < bound; ++k) {
        int nb;
        const uint64_t code = svlc_code(lanes[k], &nb);
        put_bits_bounded(out, bit, bound, code, nb);
      }
      p += cb[c];
    }
  }
}

// Fused decode tail head: bounded exp-Golomb decode + inverse quantise +
// scatter into the in-place transform-layout plane (the host decode route's
// replacement for unpack_streams_i16 + hq_dequant_scatter — no intermediate
// lane buffer, and no int16 ceiling: magnitudes decode in int32 exactly as
// the reference's bit-serial reader).
//
// Streams (one per slice-component region) decode as a GANG OF FOUR in one
// round-robin loop: each stream's decode is a serial dependency chain
// (every code's length gates the next code's position), so interleaving
// four independent chains lets the out-of-order core overlap them.
// Pathological cases (region tail, buffer edge, oversized codes) drop a
// stream out of the gang into the bounded per-code path.

namespace {

struct UDPShared {
  const uint8_t* buf;
  int64_t buflen;
  const int32_t* qm_lane;
  const int32_t* off_plane;
  int64_t L;
  // LD modes (mode 0 = HQ dequant-scatter): 1 = LD luma (first nLL lanes
  // are raw quantised-LL stores for the later prediction recurrence),
  // 2 = LD interleaved chroma (codes alternate U,V; plane lane = code/2)
  int mode = 0;
  int64_t nLL = 0;
  const int32_t* off_ll = nullptr;
};

struct UDPStream {
  int64_t pos, lim, base_bit, lane;
  int32_t* base;
  int q;
  uint64_t w;
  int navail;
  int32_t* base2 = nullptr;     // LD chroma: the V plane
  int32_t* base_ll = nullptr;   // LD: quantised-LL grid of base's plane
  int32_t* base_ll2 = nullptr;  // LD chroma: V's LL grid

  inline void dequant_to(const UDPShared& sh, int32_t* tgt, int64_t k,
                         int32_t v) {
    int aq = q - sh.qm_lane[k];
    if (aq < 0) aq = 0; else if (aq > 119) aq = 119;
    const int32_t neg = v >> 31;
    v = (v ^ neg) - neg;
    v *= kQfLut[aq];
    v += kQoLut[aq] & -static_cast<int32_t>(v > 0);
    v += 2;
    v = v < 0 ? -((-v) >> 2) : v >> 2;
    tgt[sh.off_plane[k]] = (v ^ neg) - neg;
  }

  inline void store(const UDPShared& sh, int32_t v) {
    if (sh.mode == 0) {
      dequant_to(sh, base, lane, v);
    } else if (sh.mode == 1) {
      if (lane < sh.nLL) base_ll[sh.off_ll[lane]] = v;
      else dequant_to(sh, base, lane, v);
    } else {
      const int64_t k = lane >> 1;
      if (k < sh.nLL) ((lane & 1) ? base_ll2 : base_ll)[sh.off_ll[k]] = v;
      else dequant_to(sh, (lane & 1) ? base2 : base, k, v);
    }
    ++lane;
  }

  inline void zero_fill(const UDPShared& sh) {
    for (; lane < sh.L; ++lane) {
      if (sh.mode == 0) base[sh.off_plane[lane]] = 0;
      else if (sh.mode == 1) {
        if (lane < sh.nLL) base_ll[sh.off_ll[lane]] = 0;
        else base[sh.off_plane[lane]] = 0;
      } else {
        const int64_t k = lane >> 1;
        if (k < sh.nLL) ((lane & 1) ? base_ll2 : base_ll)[sh.off_ll[k]] = 0;
        else ((lane & 1) ? base2 : base)[sh.off_plane[k]] = 0;
      }
    }
  }

  // one code via a fresh bound-masked peek (safe everywhere)
  void decode_one_peek(const UDPShared& sh) {
    const uint64_t win = peek64(sh.buf, sh.buflen, base_bit + pos, lim - pos);
    const uint64_t follow = win & 0xAAAAAAAAAAAAAAAAull;
    if (follow == 0) {
      uint32_t value = 1;
      for (;;) {
        int b = (pos < lim) ? get_bit(sh.buf, sh.buflen, base_bit + pos) : 1;
        ++pos;
        if (b) break;
        int d = (pos < lim) ? get_bit(sh.buf, sh.buflen, base_bit + pos) : 1;
        ++pos;
        value = (value << 1) | static_cast<uint32_t>(d);
      }
      int32_t v = static_cast<int32_t>(value - 1);
      if (v != 0) {
        int sign = (pos < lim) ? get_bit(sh.buf, sh.buflen, base_bit + pos) : 1;
        ++pos;
        if (sign) v = -v;
      }
      store(sh, v);
      return;
    }
    const int j = __builtin_clzll(follow) >> 1;
    int consumed = 2 * j + 1;
    const uint32_t mag = golomb_mag(win, j);
    int32_t v = static_cast<int32_t>(mag);
    if (v != 0) {
      if (win >> (63 - consumed) & 1) v = -v;
      ++consumed;
    }
    store(sh, v);
    pos += consumed;
  }

  // drain the stream with per-code peeks (tail / pathological path)
  void finish_slow(const UDPShared& sh) {
    while (lane < sh.L) {
      if (pos >= lim) { zero_fill(sh); return; }
      decode_one_peek(sh);
    }
  }

  inline bool fast_ok(const UDPShared& sh) const {
    return pos + 64 <= lim && ((base_bit + pos) >> 3) + 9 <= sh.buflen;
  }

  inline void load_window(const UDPShared& sh) {
    const int64_t abspos = base_bit + pos;
    const int64_t fb = abspos >> 3;
    const int mis = static_cast<int>(abspos & 7);
    uint64_t a;
    std::memcpy(&a, sh.buf + fb, 8);
    w = bswap64(a) << mis;
    if (mis) w |= static_cast<uint64_t>(sh.buf[fb + 8]) >> (8 - mis);
    navail = 64;
  }

  // bound-masked window: every bit at or past the region bound (and past
  // the buffer end) reads as 1 — keeps the fast loop running through the
  // short regions and region tails that the unmasked load cannot cover
  inline void load_window_masked(const UDPShared& sh) {
    w = peek64(sh.buf, sh.buflen, base_bit + pos, lim - pos);
    navail = 64;
  }

  // decode one code from the rolling window. Returns false when the stream
  // left the fast regime (caller finishes it with finish_slow) or is done.
  // Windows reload bound-masked, so the whole bounded region decodes fast;
  // past the bound the caller's pos >= lim check zero-fills.
  inline bool fast_one(const UDPShared& sh) {
    if (lane >= sh.L) return false;
    if (pos >= lim) return false;
    if (navail <= 40) {
      if (fast_ok(sh)) load_window(sh);
      else load_window_masked(sh);
    }
    const uint64_t follow = w & 0xAAAAAAAAAAAAAAAAull;
    int j;
    if (follow == 0 || (j = __builtin_clzll(follow) >> 1,
                        2 * j + 2 > navail)) {
      decode_one_peek(sh);          // pathological code
      return false;                 // window out of sync: re-enter via slow
    }
    int consumed = 2 * j + 1;
    const uint32_t mag = golomb_mag(w, j);
    int32_t v = static_cast<int32_t>(mag);
    if (v != 0) {
      if (w >> (63 - consumed) & 1) v = -v;
      ++consumed;
    }
    store(sh, v);
    pos += consumed;
    w <<= consumed;
    navail -= consumed;
    return true;
  }
};

// drive a gang of initialised streams to completion (round-robin fast
// decode, dropping to the bounded slow path per stream as needed)
static void run_gang(const UDPShared& sh, UDPStream* st, int gn) {
  unsigned mask = 0;
  for (int i = 0; i < gn; ++i) {
    st[i].navail = 0;              // fast_one loads (masked when short)
    mask |= 1u << i;
  }
  while (mask) {
    for (int i = 0; i < gn; ++i) {
      if (!(mask & (1u << i))) continue;
      if (!st[i].fast_one(sh)) {
        mask &= ~(1u << i);
        if (st[i].lane < sh.L) {
          if (st[i].pos >= st[i].lim) st[i].zero_fill(sh);
          else st[i].finish_slow(sh);
        }
      }
    }
  }
}

}  // namespace

EXPORT void unpack_dequant_plane(const uint8_t* buf, int64_t buflen,
                                 const int64_t* start, const int64_t* bound,
                                 int64_t S, int64_t L,
                                 const int32_t* q_idx,
                                 const int32_t* qm_lane,
                                 const int32_t* off_plane,
                                 int64_t xs, int64_t sh_, int64_t sw,
                                 int64_t W, int32_t* plane) {
  const UDPShared sh{buf, buflen, qm_lane, off_plane, L};
  constexpr int G = 4;
  UDPStream st[G];
  for (int64_t g0 = 0; g0 < S; g0 += G) {
    const int gn = static_cast<int>(S - g0 < G ? S - g0 : G);
    for (int i = 0; i < gn; ++i) {
      const int64_t s = g0 + i;
      st[i].pos = 0;
      st[i].lim = bound[s];
      st[i].base_bit = start[s];
      st[i].lane = 0;
      st[i].base = plane + (s / xs) * sh_ * W + (s % xs) * sw;
      st[i].q = q_idx[s];
      st[i].navail = 0;
    }
    run_gang(sh, st, gn);
  }
}

// small fixed-width big-endian field read (slice headers)
static inline int64_t read_bits_n(const uint8_t* buf, int64_t buflen,
                                  int64_t pos, int n) {
  int64_t v = 0;
  for (int i = 0; i < n; ++i)
    v = (v << 1) | get_bit(buf, buflen, pos + i);
  return v;
}

// Fused LD decode head (the LD twin of unpack_dequant_plane): per-slice
// header parse (7-bit qIndex + intlog2(8*bytes-7)-bit luma length,
// reference Slices.cpp:195-303), then bounded gang decode of the luma and
// interleaved-U,V regions — non-LL lanes inverse-quantise straight into
// the transform planes, quantised LL values collect into compact grids
// for ld_ll_dequantise's prediction recurrence. Decode tail being
// fused: /root/reference/src/DecodeStream/DecodeStream.cpp:289-450.
EXPORT void ld_unpack_dequant(
    const uint8_t* buf, int64_t buflen, int64_t start_byte,
    const int32_t* slice_bytes, int64_t ySlices, int64_t xSlices, int64_t ts,
    int64_t W, const int32_t* qm_lane_y, const int32_t* off_plane_y,
    const int32_t* off_ll_y, int64_t Ly, int64_t sliceH, int64_t sliceW,
    int64_t CW, const int32_t* qm_lane_c, const int32_t* off_plane_c,
    const int32_t* off_ll_c, int64_t Lc, int64_t csliceH, int64_t csliceW,
    int32_t* q_out, int32_t* ty, int32_t* tu, int32_t* tv,
    int32_t* llqy, int32_t* llqu, int32_t* llqv) {
  const int64_t S = ySlices * xSlices;
  const int64_t llw = W / ts, cllw = CW / ts;
  const int64_t llsh = sliceH / ts, llsw = sliceW / ts;
  const int64_t cllsh = csliceH / ts, cllsw = csliceW / ts;
  UDPShared shy{buf, buflen, qm_lane_y, off_plane_y, Ly};
  shy.mode = 1;
  shy.nLL = llsh * llsw;
  shy.off_ll = off_ll_y;
  UDPShared shc{buf, buflen, qm_lane_c, off_plane_c, 2 * Lc};
  shc.mode = 2;
  shc.nLL = cllsh * cllsw;
  shc.off_ll = off_ll_c;
  constexpr int G = 4;
  UDPStream sty[G], stc[G];
  int64_t cum = start_byte;
  for (int64_t g0 = 0; g0 < S; g0 += G) {
    const int gn = static_cast<int>(S - g0 < G ? S - g0 : G);
    for (int i = 0; i < gn; ++i) {
      const int64_t s = g0 + i;
      const int64_t v = s / xSlices, h = s % xSlices;
      const int64_t bytes = slice_bytes[s];
      const int64_t base_bit = cum * 8;
      cum += bytes;
      const int64_t total_bits = 8 * bytes;
      const int len_bits = intlog2_c(static_cast<int>(total_bits - 7));
      int q;
      int64_t luma_len;
      if (7 + len_bits <= 64) {      // one masked window covers the header
        const uint64_t hw = peek64(buf, buflen, base_bit, total_bits);
        q = static_cast<int>(hw >> 57);
        luma_len = len_bits
            ? static_cast<int64_t>((hw << 7) >> (64 - len_bits)) : 0;
      } else {
        q = static_cast<int>(read_bits_n(buf, buflen, base_bit, 7));
        luma_len = read_bits_n(buf, buflen, base_bit + 7, len_bits);
      }
      q_out[s] = q;
      int64_t clim = total_bits - 7 - len_bits - luma_len;
      if (clim < 0) clim = 0;
      sty[i].pos = 0;
      sty[i].lim = luma_len;
      sty[i].base_bit = base_bit + 7 + len_bits;
      sty[i].lane = 0;
      sty[i].base = ty + v * sliceH * W + h * sliceW;
      sty[i].base_ll = llqy + v * llsh * llw + h * llsw;
      sty[i].q = q;
      sty[i].navail = 0;
      stc[i].pos = 0;
      stc[i].lim = clim;
      stc[i].base_bit = base_bit + 7 + len_bits + luma_len;
      stc[i].lane = 0;
      stc[i].base = tu + v * csliceH * CW + h * csliceW;
      stc[i].base2 = tv + v * csliceH * CW + h * csliceW;
      stc[i].base_ll = llqu + v * cllsh * cllw + h * cllsw;
      stc[i].base_ll2 = llqv + v * cllsh * cllw + h * cllsw;
      stc[i].q = q;
      stc[i].navail = 0;
    }
    run_gang(shy, sty, gn);
    run_gang(shc, stc, gn);
  }
}

// LL-subband predictive inverse quantise from the compact quantised-LL
// grid (reference inverse_quantise_LLSubband, Quantisation.cpp:287-306),
// reconstructed values scattered into the in-place transform plane.
// Compact-grid variant: the dequantised LL values land in out_ll (llh x
// llw), which doubles as the recurrence state. Used by the device decode
// route, which ships only this small grid to the chip.
EXPORT void ld_ll_dequantise_grid(const int32_t* llq, int64_t llh,
                                  int64_t llw, int64_t ySlices,
                                  int64_t xSlices, int64_t ts,
                                  int64_t sliceH, int64_t sliceW,
                                  const int32_t* qm_block,
                                  const int32_t* q_idx, int32_t* out_ll) {
  for (int64_t y = 0; y < llh; ++y) {
    for (int64_t x = 0; x < llw; ++x) {
      const int64_t yb = ((y + 1) * ySlices - 1) / llh;
      const int64_t xb = ((x + 1) * xSlices - 1) / llw;
      const int64_t yy = y * ts, xx = x * ts;
      const int aq = adjust_q(q_idx[yb * xSlices + xb],
                              qm_block[(yy % sliceH) * sliceW + (xx % sliceW)]);
      const int pred = predict_dc(out_ll, llw, y, x);
      out_ll[y * llw + x] = c_scale(llq[y * llw + x], aq) + pred;
    }
  }
}

EXPORT void ld_ll_dequantise(const int32_t* llq, int64_t llh, int64_t llw,
                             int64_t ySlices, int64_t xSlices, int64_t ts,
                             int64_t sliceH, int64_t sliceW,
                             const int32_t* qm_block, const int32_t* q_idx,
                             int32_t* plane, int64_t W) {
  int32_t* ll = new int32_t[llh * llw];
  ld_ll_dequantise_grid(llq, llh, llw, ySlices, xSlices, ts, sliceH, sliceW,
                        qm_block, q_idx, ll);
  for (int64_t y = 0; y < llh; ++y)
    for (int64_t x = 0; x < llw; ++x)
      plane[y * ts * W + x * ts] = ll[y * llw + x];
  delete[] ll;
}
