// Baseline-JPEG entropy decoder: bytes -> luma DCT coefficients.
//
// The host-side half of the framework's TPU JPEG decode path (ops/jpeg.py).
// Full host JPEG decode (libjpeg via cv2.imdecode) spends most of its time
// in the IDCT + color stages, which are dense linear algebra — exactly what
// the TPU's MXU eats. The only genuinely serial, branchy part of JPEG is the
// Huffman entropy decode, so that is all this file does: parse the headers,
// entropy-decode the scan, and emit the luma (Y) component's quantized DCT
// coefficients in natural (de-zigzagged) order plus the quantization table.
// Dequantization, the 8x8 IDCT (two small matmuls), level shift, and block
// reassembly all run batched on the TPU.
//
// Two emission formats, one scan decoder (templated sink):
//
//  * DENSE:  int16[blocks * 64], block row-major. 2 bytes/coefficient =
//    614 KB/frame at 640x480 — 2x the raw gray bytes, so on a bandwidth-
//    limited host->TPU link this format loses to raw-pixel transport.
//  * DELTA (sparse): quantized luma blocks are overwhelmingly zeros (q70
//    dark scenes: ~1-4 nonzeros/block), so ship one (gap, value) pair per
//    nonzero, addressed in the batch's FLAT coefficient space
//    pos = (frame*blocks + block)*64 + natural_index:
//      - gaps:    uint8, strictly positive position deltas (prev starts at
//                 -1); a gap > 255 is bridged by filler entries
//                 (gap=255, value=0) — they land on zero slots of the
//                 pre-zeroed tensor, so they are harmless by construction
//      - values:  int8, the coefficient clamped to [-127, 127]
//      - spill:   the rare |coeff| > 127 get a second (gap uint8,
//                 delta int16 = v - clamp(v)) stream with the same
//                 filler rule, ADDED on top of the clamped scatter
//    ~3 bytes per nonzero (~40-60 KB/frame at 480p q70). The TPU expands
//    this with ONE cumsum + ONE sorted-unique scatter + the spill add
//    (ops/jpeg.py:delta_idct_frames) — measured ~25x faster than the
//    earlier bitmask format's per-output-element gather expansion, whose
//    78M scalar gathers per 256-frame batch serialized on the TPU.
//
// Scope: baseline sequential DCT (SOF0), 8-bit, Huffman, 1 or 3 components,
// luma sampling factors up to 2x2 with 1x1 chroma (covers libjpeg/cv2
// MJPG/imencode output and the acquisition server's stream,
// collecting.py:130). Restart markers (DRI/RSTn) supported. Chroma
// coefficients are decoded (the bitstream is interleaved) but not stored —
// the perception pipeline is grayscale (marker_detection.py:114).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

#include <thread>
#include <vector>

namespace {

// True when any byte of x equals 0xFF (classic SWAR has-zero test on the
// complement) — gates the BitReader's bulk refill fast path: 0xFF bytes
// need the stuffing/marker logic, everything else can be appended 8 bytes
// at a time.
inline bool has_ff_byte(uint64_t x) {
  const uint64_t v = x ^ 0xFFFFFFFFFFFFFFFFull;  // 0xFF bytes become 0x00
  return ((v - 0x0101010101010101ull) & ~v & 0x8080808080808080ull) != 0;
}

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t x;
  std::memcpy(&x, p, 8);
#if defined(__GNUC__) || defined(__clang__)
  return __builtin_bswap64(x);
#else
  uint64_t r = 0;
  for (int i = 0; i < 8; ++i) r = (r << 8) | p[i];
  return r;
#endif
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bits = 0;   // bit accumulator (valid bits MSB-aligned)
  int nbits = 0;       // valid bits in accumulator
  bool saw_marker = false;

  explicit BitReader(const uint8_t* data, const uint8_t* e) : p(data), end(e) {}

  // Refill the accumulator to > 56 valid bits. Fast path: when the next 8
  // bytes contain no 0xFF (the overwhelmingly common case — stuffing and
  // markers are rare), append 4+ whole bytes with one 64-bit load instead
  // of the per-byte stuffing checks. Measured ~3-4% on the full entropy
  // decode (benchmarks/bench_entropy.py: 0.205 -> 0.197 ms/frame at 480p
  // q70) — symbol decode + emit dominate; the win is the rarer, cheaper
  // refill. Slow path: byte-at-a-time with 0xFF00 stuffing; on a real
  // marker (RSTn/EOI/...) stops feeding (zeros thereafter).
  inline void fill() {
    while (nbits <= 56) {
      if (!saw_marker && p + 8 <= end) {
        uint64_t x;
        std::memcpy(&x, p, 8);
        if (!has_ff_byte(x)) {
          const int k = (64 - nbits) >> 3;   // whole bytes that fit (>= 1)
          const uint64_t be = load_be64(p);
          // Append exactly the top k bytes (mask keeps later bytes from
          // leaking partial bits that would be re-read on the next load).
          const uint64_t top = (k == 8) ? be
                                        : (be & (~0ull << (64 - 8 * k)));
          bits |= top >> nbits;
          nbits += 8 * k;
          p += k;
          continue;
        }
      }
      uint8_t b = 0;
      if (p < end && !saw_marker) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t nxt = (p + 1 < end) ? p[1] : 0xD9;
          if (nxt == 0x00) {
            p += 2;  // stuffed FF
            bits |= static_cast<uint64_t>(0xFF) << (56 - nbits);
            nbits += 8;
            continue;
          }
          saw_marker = true;  // leave p AT the 0xFF of the marker
          b = 0;
        } else {
          ++p;
        }
      }
      bits |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }

  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(bits >> (64 - n));
  }

  inline void skip(int n) {
    bits <<= n;
    nbits -= n;
  }

  inline int32_t receive_extend(int s) {
    if (s == 0) return 0;
    if (nbits < s) fill();
    int32_t v = static_cast<int32_t>(bits >> (64 - s));
    skip(s);
    if (v < (1 << (s - 1))) v -= (1 << s) - 1;  // T.81 EXTEND
    return v;
  }

  // Byte-align and consume an expected RSTn marker.
  inline bool restart() {
    bits = 0;
    nbits = 0;
    if (!saw_marker) {
      // Scan forward to the marker (tolerate padding bits).
      while (p < end && *p != 0xFF) ++p;
    }
    if (p + 1 >= end) return false;
    if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      saw_marker = false;
      return true;
    }
    return false;
  }
};

struct Huff {
  // Two-level decode: 9-bit lookahead LUT, then the T.81 min/max-code walk.
  uint8_t lut_sym[512];
  int8_t lut_len[512];
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t vals[256];
  bool ok = false;

  bool build(const uint8_t counts[16], const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    uint16_t codes[256];
    uint8_t sizes[256];
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; ++i) {
        codes[k] = static_cast<uint16_t>(code);
        sizes[k] = static_cast<uint8_t>(l);
        ++code;
        ++k;
      }
      // Kraft check: an over-subscribed table (code > 2^l after assigning
      // this length's codes) is invalid per T.81 C.2 — and without this
      // rejection the 9-bit LUT fill below computes codes[i] << shift
      // past lut_sym[512], an attacker-controlled stack WRITE from pure
      // header bytes (round-3 security review).
      if (code > (1 << l)) { ok = false; return false; }
      maxcode[l] = code - 1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < 512; ++i) lut_len[i] = 0;
    for (int i = 0; i < k; ++i) {
      if (sizes[i] <= 9) {
        const int shift = 9 - sizes[i];
        const int base = codes[i] << shift;
        for (int j = 0; j < (1 << shift); ++j) {
          lut_sym[base + j] = vals[i];
          lut_len[base + j] = static_cast<int8_t>(sizes[i]);
        }
      }
    }
    ok = true;
    return true;
  }

  inline int decode(BitReader& br) const {
    const uint32_t look = br.peek(9);
    const int8_t l = lut_len[look];
    if (l != 0) {
      br.skip(l);
      return lut_sym[look];
    }
    // Long code: walk lengths 10..16.
    int32_t code = static_cast<int32_t>(br.peek(16));
    for (int len = 10; len <= 16; ++len) {
      const int32_t c = code >> (16 - len);
      if (c <= maxcode[len]) {
        br.skip(len);
        return vals[valptr[len] + (c - mincode[len])];
      }
    }
    return -1;  // corrupt stream
  }
};

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int64_t pred = 0;  // int32 overflows on adversarial DC chains (UB)
};

inline int rd16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Error codes (shared by dense and delta paths; ops/jpeg.py matches on
// kErrCapacity to grow its probe buffer and on kErrValCap/kErrSpillCap to
// grow the delta streams — every other code is a hard parse failure).
enum {
  kErrCapacity = -11,   // dense: block capacity exceeded (growable)
  kErrValCap = -100,    // delta: entry stream capacity exceeded (growable)
  kErrSpillCap = -102,  // delta: spill stream capacity exceeded (growable)
  kErrAcCap = -104,     // split: AC byte stream capacity exceeded (growable)
  kErrAcSpillCap = -105,  // split: AC spill capacity exceeded (growable)
  kErrDcSpillCap = -106,  // split: DC spill capacity exceeded (growable)
};

// Emit a decoded Y block into the DENSE layout. `out` must be pre-zeroed;
// only the nonzero coefficients (mask bits) are written.
struct DenseSink {
  static constexpr bool kZigzagOrder = false;  // natural (de-zigzagged)
  int16_t* out;  // blocks * 64, block row-major

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    int16_t* dst = out + block * 64;
    while (mask) {
      const int j = __builtin_ctzll(mask);
      mask &= mask - 1;
      dst[j] = scratch[j];
    }
    return 0;
  }
};

// Emit into the DELTA layout (see file header). Cursors and the previous
// positions persist across frames so one cumsum on the device reconstructs
// every position in the batch's flat coefficient space.
struct DeltaSink {
  static constexpr bool kZigzagOrder = false;  // natural (de-zigzagged)
  uint8_t* gaps;
  int8_t* vals;
  int64_t cap, n = 0;
  uint8_t* sgaps;
  int16_t* sdeltas;
  int64_t scap, sn = 0;
  int64_t prev = -1, sprev = -1;  // last emitted flat positions
  int64_t frame_base = 0;         // frame_index * blocks * 64

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    const int64_t base = frame_base + block * 64;
    while (mask) {
      const int j = __builtin_ctzll(mask);
      mask &= mask - 1;
      const int64_t pos = base + j;
      int64_t gap = pos - prev;
      while (gap > 255) {  // filler entries bridge long zero runs
        if (n >= cap) return kErrValCap;
        gaps[n] = 255;
        vals[n] = 0;
        ++n;
        gap -= 255;
      }
      if (n >= cap) return kErrValCap;
      const int16_t v = scratch[j];
      const int16_t c = v > 127 ? 127 : (v < -127 ? -127 : v);
      gaps[n] = static_cast<uint8_t>(gap);
      vals[n] = static_cast<int8_t>(c);
      ++n;
      prev = pos;
      if (v != c) {  // spill: the remainder rides the int16 side stream
        int64_t sgap = pos - sprev;
        while (sgap > 255) {
          if (sn >= scap) return kErrSpillCap;
          sgaps[sn] = 255;
          sdeltas[sn] = 0;
          ++sn;
          sgap -= 255;
        }
        if (sn >= scap) return kErrSpillCap;
        sgaps[sn] = static_cast<uint8_t>(sgap);
        sdeltas[sn] = static_cast<int16_t>(v - c);
        ++sn;
        sprev = pos;
      }
    }
    return 0;
  }
};

// DELTA layout into growable thread-local vectors (multithreaded batch
// path): same encoding as DeltaSink, but capacity never fails — each worker
// owns its buffers and the main thread stitches slices afterwards.
struct DeltaVecSink {
  static constexpr bool kZigzagOrder = false;  // natural (de-zigzagged)
  std::vector<uint8_t> gaps;
  std::vector<int8_t> vals;
  std::vector<uint8_t> sgaps;
  std::vector<int16_t> sdeltas;
  int64_t prev = -1, sprev = -1;
  int64_t frame_base = 0;

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    const int64_t base = frame_base + block * 64;
    while (mask) {
      const int j = __builtin_ctzll(mask);
      mask &= mask - 1;
      const int64_t pos = base + j;
      int64_t gap = pos - prev;
      while (gap > 255) {
        gaps.push_back(255);
        vals.push_back(0);
        gap -= 255;
      }
      const int16_t v = scratch[j];
      const int16_t c = v > 127 ? 127 : (v < -127 ? -127 : v);
      gaps.push_back(static_cast<uint8_t>(gap));
      vals.push_back(static_cast<int8_t>(c));
      prev = pos;
      if (v != c) {
        int64_t sgap = pos - sprev;
        while (sgap > 255) {
          sgaps.push_back(255);
          sdeltas.push_back(0);
          sgap -= 255;
        }
        sgaps.push_back(static_cast<uint8_t>(sgap));
        sdeltas.push_back(static_cast<int16_t>(v - c));
        sprev = pos;
      }
    }
    return 0;
  }
};

// Emit into the SPLIT layout: DC and AC coefficients ride separate streams
// sized to their statistics (~25% of nonzeros are block DCs with large
// values and no gap information; ACs have small gaps and small values).
//
// * DC: ONE NIBBLE per block, dense, two per byte, with a per-frame FLAG
//   nibble prepended (frame lane = ceil((blocks+1)/2) whole bytes; nibble
//   2k = low nibble of byte k; nibble 0 is the flag, block j rides nibble
//   j+1). The nibble is a clamped-to-[-7, 7] DELTA whose predictor the
//   encoder picks PER FRAME (the flag):
//     - flag 0, SPATIAL: the previous block's absolute DC within the
//       frame (JPEG's own predictor; block 0 deltas from 0) — always
//       available, wins on scene cuts and noise;
//     - flag 1, TEMPORAL: the SAME block's absolute DC in the PREVIOUS
//       frame — MJPEG scenes move slowly, so these deltas are
//       overwhelmingly 0 and fit the nibble ~98% of the time where
//       spatial deltas fit int8 only ~87%.
//   The encoder counts would-be spills under both predictors and takes
//   the cheaper one, so adversarial (noise) streams degrade to exactly
//   the spatial cost instead of spilling every block. Residuals
//   (delta - clamp) spill to the (gap uint16 over block indices, int16)
//   side stream — no escape codes in the lane itself. The device
//   reconstructs with a flag-segmented prefix sum over the frame axis
//   (ops/jpeg.py:split_idct_frames). Halves the round-4 dense int8 lane.
// * AC: a variable-length byte stream (1 or 2 bytes per entry) in the
//   nslots-per-block ZIGZAG AC position space (nslots = zmax-1; pos =
//   block*nslots + zigzag_index-1 — scan order, so JPEG's own run-lengths
//   keep gaps tiny). Entry first byte: low 3 bits gap-1 (gap 1..8), high
//   5 bits the value code:
//     - codes -14..15 : SHORT entry, the value itself (one byte total);
//     - code  -16     : ESCAPE advancing (low3+1)*nslots positions (1..8
//                       whole empty blocks), emitting nothing;
//     - code  -15     : EXT marker — the NEXT byte is the value as int8
//                       (two bytes total; |v| > 127 clamps and spills the
//                       remainder to the uint16-gap/int16 side stream,
//                       which q70-class streams then use ~never).
//   Gaps 9..nslots bridge with zero-value gap-8 short fillers. The 1/2-
//   byte framing is self-synchronizing UTF-8 style: after any byte whose
//   value code is not EXT, the next byte starts an entry, so entry starts
//   are recoverable by a parity scan over the EXT-code flag — which is
//   exactly how the TPU decodes this stream with no gathers
//   (ops/jpeg.py:split_idct_frames). Replaces the round-4 format's
//   clamp-to-[-15,15] + 4-byte spill pair (1 entry byte + 4 spill bytes
//   -> 2 bytes for every |v| in 16..127 — measured ~3.7 KB/frame on q70
//   480p, the difference between clearing the 1000 fps ingest bar on a
//   22 MB/s link day and missing it).
//
// zmax (2..64, default 64) BAND-LIMITS the transport: AC coefficients at
// zigzag scan index >= zmax are dropped at emit time and the position
// space shrinks to zmax-1 slots/block. zmax=64 is the exact (lossless)
// transport. Lower zmax is the detect-grade profile (ops/jpeg.py header):
// the marker pipeline's own Gaussian blurs (sigma >= 4.56,
// marker_detection.py:118-124) attenuate every frequency pair with
// k+l >= 4 by < 3e-6, so dropping the high-zigzag tail changes the
// pipeline's outputs by measurement noise while cutting both link bytes
// and host emit work (tests/test_jpeg.py pins the end-to-end envelope).
//
// ~1 byte/AC + 1 byte/block beats the 2-byte delta pairs by ~40% on real
// q70 streams (measured 40 -> 24.5 KB/frame at 480p) — the transport is
// for host->TPU links where bytes are the wall (benchmarks/README.md).
struct SplitSink {
  static constexpr bool kZigzagOrder = true;  // see emit(): zigzag gaps
  uint8_t* ac;
  int64_t ac_cap, ac_n = 0;
  uint8_t* dc;     // nibble lane: ceil(blocks/2) bytes per frame
  // Spill gaps are uint16: spills are sparse (mean gap ~100+ positions),
  // so uint8 gaps spent ~half the spill stream on (255, 0) fillers —
  // 4 bytes per real spill beats 3 bytes per (real + filler) entry.
  uint16_t* sgaps;  // AC spill
  int16_t* sdeltas;
  int64_t scap, sn = 0;
  uint16_t* dgaps;  // DC spill
  int16_t* ddeltas;
  int64_t dcap, dn = 0;
  int64_t prev_ac = -1, sprev = -1, dprev = -1;
  int64_t frame_block_base = 0;  // frame_index * blocks_per_frame
  int nslots = 63;               // zmax - 1 AC slots per block (band limit)
  int blocks_per_frame = 0;      // the real grid (bw*bh): lane addressing
  int frame_index = 0;           // batch-local
  int32_t* cur_frame_dc = nullptr;   // this frame's absolute DCs (scratch)
  int32_t* prev_frame_dc = nullptr;  // previous frame's absolute DCs
  bool have_prev = false;            // temporal predictor available

  // Per-frame DC flush: pick the cheaper predictor (spills under each),
  // write the flag + delta nibbles and the spill residuals. Called by the
  // batch driver after each frame's decode_y.
  inline int flush_dc() {
    const int nb = blocks_per_frame;
    int sp = 0, tp = 0;
    int32_t prevb = 0;
    for (int j = 0; j < nb; ++j) {
      const int32_t d = cur_frame_dc[j] - prevb;
      prevb = cur_frame_dc[j];
      sp += (d < -7) | (d > 7);
    }
    if (have_prev) {
      for (int j = 0; j < nb; ++j) {
        const int32_t d = cur_frame_dc[j] - prev_frame_dc[j];
        tp += (d < -7) | (d > 7);
      }
    }
    const bool temporal = have_prev && tp <= sp;
    const int64_t bpf2 = (nb + 2) / 2;  // ceil((nb + 1) / 2) whole bytes
    uint8_t* lane = dc + static_cast<int64_t>(frame_index) * bpf2;
    lane[0] = temporal ? 1 : 0;  // flag nibble (high nibble of byte 0 is
    prevb = 0;                   // block 0's delta, written below)
    for (int j = 0; j < nb; ++j) {
      const int32_t d =
          cur_frame_dc[j] - (temporal ? prev_frame_dc[j] : prevb);
      prevb = cur_frame_dc[j];
      const int32_t c = d > 7 ? 7 : (d < -7 ? -7 : d);
      uint8_t* byte = lane + (j + 1) / 2;
      if ((j + 1) & 1)
        *byte |= static_cast<uint8_t>((c & 15) << 4);
      else
        *byte = static_cast<uint8_t>(c & 15);
      if (d != c) {
        const int64_t gblock = frame_block_base + j;
        int64_t g = gblock - dprev;
        while (g > 65535) {
          if (dn >= dcap) return kErrDcSpillCap;
          dgaps[dn] = 65535;
          ddeltas[dn] = 0;
          ++dn;
          g -= 65535;
        }
        if (dn >= dcap) return kErrDcSpillCap;
        dgaps[dn] = static_cast<uint16_t>(g);
        ddeltas[dn] = static_cast<int16_t>(d - c);
        ++dn;
        dprev = gblock;
      }
    }
    std::memcpy(prev_frame_dc, cur_frame_dc,
                static_cast<size_t>(nb) * sizeof(int32_t));
    have_prev = true;
    return 0;
  }

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    const int64_t gblock = frame_block_base + block;
    cur_frame_dc[block] = (mask & 1) ? scratch[0] : 0;
    // Band limit: keep AC slots 1..nslots only (mask bit j = zigzag index).
    uint64_t m = mask & ~1ull;
    if (nslots < 63)
      m &= (1ull << (nslots + 1)) - 1;
    const int64_t base = gblock * nslots - 1;  // pos = base + j, slot j >= 1
    while (m) {
      const int j = __builtin_ctzll(m);
      m &= m - 1;
      const int64_t pos = base + j;
      int64_t gap = pos - prev_ac;  // >= 1: positions strictly increase
      while (gap - 1 >= nslots) {   // whole empty blocks -> escape bytes
        int64_t k = (gap - 1) / nslots;
        if (k > 8) k = 8;
        if (ac_n >= ac_cap) return kErrAcCap;
        ac[ac_n++] = static_cast<uint8_t>((k - 1) | 0x80);
        gap -= k * nslots;
      }
      while (gap > 8) {  // remaining 9..nslots -> zero-value gap-8 fillers
        if (ac_n >= ac_cap) return kErrAcCap;
        ac[ac_n++] = 7;  // gap 8, value 0
        gap -= 8;
      }
      const int16_t v = scratch[j];
      if (v >= -14 && v <= 15) {  // SHORT: value rides the 5-bit code
        if (ac_n >= ac_cap) return kErrAcCap;
        ac[ac_n++] = static_cast<uint8_t>(
            (gap - 1) | ((static_cast<int>(v) & 31) << 3));
      } else {  // EXT: code -15 marks a second byte carrying int8 value
        const int16_t cv = v > 127 ? 127 : (v < -127 ? -127 : v);
        if (ac_n + 2 > ac_cap) return kErrAcCap;
        ac[ac_n++] = static_cast<uint8_t>((gap - 1) | ((17 & 31) << 3));
        ac[ac_n++] = static_cast<uint8_t>(static_cast<int8_t>(cv));
        if (v != cv) {
          int64_t sg = pos - sprev;
          while (sg > 65535) {
            if (sn >= scap) return kErrAcSpillCap;
            sgaps[sn] = 65535;
            sdeltas[sn] = 0;
            ++sn;
            sg -= 65535;
          }
          if (sn >= scap) return kErrAcSpillCap;
          sgaps[sn] = static_cast<uint16_t>(sg);
          sdeltas[sn] = static_cast<int16_t>(v - cv);
          ++sn;
          sprev = pos;
        }
      }
      prev_ac = pos;
    }
    return 0;
  }
};

// SPLIT layout into growable thread-local vectors (multithreaded batch
// path): same encoding as SplitSink, but AC/spill capacity never fails —
// each worker owns its stream buffers and the main thread stitches slices
// afterwards. DC deltas write DIRECTLY into the caller's dense buffer:
// slices own disjoint [a*blocks, b*blocks) ranges and the per-frame
// prediction reset makes the stream position-independent — nothing to
// stitch.
struct SplitVecSink {
  static constexpr bool kZigzagOrder = true;
  std::vector<uint8_t> ac;
  uint8_t* dc;  // caller's out_dc + a*ceil(blocks/2) (disjoint byte slice)
  std::vector<uint16_t> sgaps;
  std::vector<int16_t> sdeltas;
  std::vector<uint16_t> dgaps;
  std::vector<int16_t> ddeltas;
  int64_t prev_ac = -1, sprev = -1, dprev = -1;
  int64_t frame_block_base = 0;
  int nslots = 63;  // zmax - 1 AC slots per block (band limit)
  int blocks_per_frame = 0;
  int frame_index = 0;  // batch-local GLOBAL index
  int slice_start = 0;  // first frame of this worker's slice
  std::vector<int32_t> cur_frame_dc;
  std::vector<int32_t> prev_frame_dc;
  bool have_prev = false;

  // See SplitSink::flush_dc — vector-backed spills, slice-local lane.
  inline int flush_dc() {
    const int nb = blocks_per_frame;
    int sp = 0, tp = 0;
    int32_t prevb = 0;
    for (int j = 0; j < nb; ++j) {
      const int32_t d = cur_frame_dc[j] - prevb;
      prevb = cur_frame_dc[j];
      sp += (d < -7) | (d > 7);
    }
    if (have_prev) {
      for (int j = 0; j < nb; ++j) {
        const int32_t d = cur_frame_dc[j] - prev_frame_dc[j];
        tp += (d < -7) | (d > 7);
      }
    }
    const bool temporal = have_prev && tp <= sp;
    const int64_t bpf2 = (nb + 2) / 2;
    uint8_t* lane = dc +
        static_cast<int64_t>(frame_index - slice_start) * bpf2;
    lane[0] = temporal ? 1 : 0;
    prevb = 0;
    for (int j = 0; j < nb; ++j) {
      const int32_t d =
          cur_frame_dc[j] - (temporal ? prev_frame_dc[j] : prevb);
      prevb = cur_frame_dc[j];
      const int32_t c = d > 7 ? 7 : (d < -7 ? -7 : d);
      uint8_t* byte = lane + (j + 1) / 2;
      if ((j + 1) & 1)
        *byte |= static_cast<uint8_t>((c & 15) << 4);
      else
        *byte = static_cast<uint8_t>(c & 15);
      if (d != c) {
        const int64_t gblock = frame_block_base + j;
        int64_t g = gblock - dprev;
        while (g > 65535) {
          dgaps.push_back(65535);
          ddeltas.push_back(0);
          g -= 65535;
        }
        dgaps.push_back(static_cast<uint16_t>(g));
        ddeltas.push_back(static_cast<int16_t>(d - c));
        dprev = gblock;
      }
    }
    std::memcpy(prev_frame_dc.data(), cur_frame_dc.data(),
                static_cast<size_t>(nb) * sizeof(int32_t));
    have_prev = true;
    return 0;
  }

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    const int64_t gblock = frame_block_base + block;
    cur_frame_dc[block] = (mask & 1) ? scratch[0] : 0;
    uint64_t m = mask & ~1ull;
    if (nslots < 63)
      m &= (1ull << (nslots + 1)) - 1;
    const int64_t base = gblock * nslots - 1;
    while (m) {
      const int j = __builtin_ctzll(m);
      m &= m - 1;
      const int64_t pos = base + j;
      int64_t gap = pos - prev_ac;
      while (gap - 1 >= nslots) {
        int64_t k = (gap - 1) / nslots;
        if (k > 8) k = 8;
        ac.push_back(static_cast<uint8_t>((k - 1) | 0x80));
        gap -= k * nslots;
      }
      while (gap > 8) {
        ac.push_back(7);
        gap -= 8;
      }
      const int16_t v = scratch[j];
      if (v >= -14 && v <= 15) {
        ac.push_back(static_cast<uint8_t>(
            (gap - 1) | ((static_cast<int>(v) & 31) << 3)));
      } else {
        const int16_t cv = v > 127 ? 127 : (v < -127 ? -127 : v);
        ac.push_back(static_cast<uint8_t>((gap - 1) | ((17 & 31) << 3)));
        ac.push_back(static_cast<uint8_t>(static_cast<int8_t>(cv)));
        if (v != cv) {
          int64_t sg = pos - sprev;
          while (sg > 65535) {
            sgaps.push_back(65535);
            sdeltas.push_back(0);
            sg -= 65535;
          }
          sgaps.push_back(static_cast<uint16_t>(sg));
          sdeltas.push_back(static_cast<int16_t>(v - cv));
          sprev = pos;
        }
      }
      prev_ac = pos;
    }
    return 0;
  }
};

// Emit into the TDELTA (temporal-delta) layout: ONE VLC byte stream over
// the zmax-slot-per-block ZIGZAG space (slot 0 = DC), whose entry values
// are the TEMPORAL DELTAS of each block's quantized coefficient vector
// against the previous frame (frame 0: against all-zeros, i.e. absolute).
//
// Why: an MJPEG sensor stream is a statically-mounted camera watching a
// slowly-deforming gel — measured on the q70 480p bench stream, 95.7% of
// blocks are BIT-IDENTICAL to the previous frame and the batch-wide delta
// has ~662 nonzeros/frame vs ~18,700 absolute, so shipping deltas cuts the
// exact-transport link bytes ~8x below SPLIT (benchmarks/README.md round
// 5). Reconstruction is ONE cumsum over the frame axis (deltas telescope:
// every prefix sum IS a real frame's quantized coefficients, so int16
// never overflows), then the shared zigzag dequant-IDCT. Per-frame qtables
// stay exact: deltas live in QUANTIZED space; each frame dequantizes with
// its own table after the cumsum.
//
// Entry format = SplitSink's AC VLC with one extension (positions are
// pos = (frame*blocks + block) * nslots + zigzag_index, nslots = zmax):
//   first byte: low 3 bits gap-1 (gap 1..8), high 5 bits the value code:
//     - codes -14..15 : SHORT, the delta itself (one byte);
//     - code  -15     : EXT, next byte is the delta as int8 (|d| > 127
//                       clamps + spills the remainder to the uint16-gap/
//                       int16 side stream);
//     - code  -16     : ESCAPE — low 3 bits k-1 with k in 1..7 skips k
//                       whole blocks (one byte); k == 8 (low == 7) is the
//                       TWO-byte form whose second byte B skips 8+B blocks
//                       (8..263) — on replenishment streams ~96% of blocks
//                       ship nothing, so whole-frame skips must not cost
//                       hundreds of 8-block escapes (SplitSink's cap).
//   Framing stays self-synchronizing: EXT and two-byte-ESCAPE first bytes
//   both mark exactly one payload byte, so entry starts are recoverable by
//   the same parity scan (ops/jpeg.py:tdelta_idct_frames).
//
// zmax (2..64) band-limits exactly like SplitSink: slots >= zmax are
// ignored on BOTH sides of the delta (decode = dense with that tail
// zeroed). Noise-heavy streams degrade boundedly: the delta support is at
// most nnz(cur) + nnz(prev), ~2x SPLIT's entry count — the transport is
// selected per deployment (io/video.MjpegAviTpuSource(transport=...)).
struct TDeltaSink {
  static constexpr bool kZigzagOrder = true;
  uint8_t* ac;
  int64_t ac_cap, ac_n = 0;
  uint16_t* sgaps;
  int16_t* sdeltas;
  int64_t scap, sn = 0;
  int64_t prev_pos = -1, sprev = -1;
  int64_t frame_block_base = 0;  // frame_index * blocks_per_frame
  int nslots = 64;               // zmax slots per block (slot 0 = DC)
  int16_t* prev;                 // (blocks * 64) int16, zigzag-indexed
  uint64_t* prev_mask;           // (blocks,) nonzero-slot mask of prev

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    const uint64_t lim =
        nslots >= 64 ? ~0ull : ((1ull << nslots) - 1);
    int16_t* pv = prev + block * 64;
    uint64_t un = (mask | prev_mask[block]) & lim;
    const int64_t base = (frame_block_base + block) * nslots;
    while (un) {
      const int j = __builtin_ctzll(un);
      un &= un - 1;
      const int16_t cur =
          (mask >> j & 1) ? scratch[j] : static_cast<int16_t>(0);
      const int32_t d = static_cast<int32_t>(cur) - pv[j];
      pv[j] = cur;
      if (d == 0) continue;
      const int64_t pos = base + j;
      int64_t gap = pos - prev_pos;  // >= 1
      while (gap - 1 >= nslots) {    // whole silent blocks -> escapes
        int64_t k = (gap - 1) / nslots;
        if (k <= 7) {
          if (ac_n >= ac_cap) return kErrAcCap;
          ac[ac_n++] = static_cast<uint8_t>((k - 1) | 0x80);
        } else {
          if (k > 263) k = 263;
          if (ac_n + 2 > ac_cap) return kErrAcCap;
          ac[ac_n++] = static_cast<uint8_t>(7 | 0x80);
          ac[ac_n++] = static_cast<uint8_t>(k - 8);
        }
        gap -= k * nslots;
      }
      while (gap > 8) {  // in-block remainder -> zero-value gap-8 fillers
        if (ac_n >= ac_cap) return kErrAcCap;
        ac[ac_n++] = 7;
        gap -= 8;
      }
      if (d >= -14 && d <= 15) {
        if (ac_n >= ac_cap) return kErrAcCap;
        ac[ac_n++] = static_cast<uint8_t>((gap - 1) | ((d & 31) << 3));
      } else {
        const int32_t cv = d > 127 ? 127 : (d < -127 ? -127 : d);
        if (ac_n + 2 > ac_cap) return kErrAcCap;
        ac[ac_n++] = static_cast<uint8_t>((gap - 1) | ((17 & 31) << 3));
        ac[ac_n++] = static_cast<uint8_t>(static_cast<int8_t>(cv));
        if (d != cv) {
          int64_t sg = pos - sprev;
          while (sg > 65535) {
            if (sn >= scap) return kErrAcSpillCap;
            sgaps[sn] = 65535;
            sdeltas[sn] = 0;
            ++sn;
            sg -= 65535;
          }
          if (sn >= scap) return kErrAcSpillCap;
          sgaps[sn] = static_cast<uint16_t>(sg);
          sdeltas[sn] = static_cast<int16_t>(d - cv);
          ++sn;
          sprev = pos;
        }
      }
      prev_pos = pos;
    }
    prev_mask[block] = mask & lim;
    return 0;
  }
};

// TDELTA into growable thread-local vectors (multithreaded batch path) —
// same encoding as TDeltaSink, worker-owned buffers, stitched afterwards.
struct TDeltaVecSink {
  static constexpr bool kZigzagOrder = true;
  std::vector<uint8_t> ac;
  std::vector<uint16_t> sgaps;
  std::vector<int16_t> sdeltas;
  int64_t prev_pos = -1, sprev = -1;
  int64_t frame_block_base = 0;
  int nslots = 64;
  std::vector<int16_t> prev;
  std::vector<uint64_t> prev_mask;

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    const uint64_t lim =
        nslots >= 64 ? ~0ull : ((1ull << nslots) - 1);
    int16_t* pv = prev.data() + block * 64;
    uint64_t un = (mask | prev_mask[block]) & lim;
    const int64_t base = (frame_block_base + block) * nslots;
    while (un) {
      const int j = __builtin_ctzll(un);
      un &= un - 1;
      const int16_t cur =
          (mask >> j & 1) ? scratch[j] : static_cast<int16_t>(0);
      const int32_t d = static_cast<int32_t>(cur) - pv[j];
      pv[j] = cur;
      if (d == 0) continue;
      const int64_t pos = base + j;
      int64_t gap = pos - prev_pos;
      while (gap - 1 >= nslots) {
        int64_t k = (gap - 1) / nslots;
        if (k <= 7) {
          ac.push_back(static_cast<uint8_t>((k - 1) | 0x80));
        } else {
          if (k > 263) k = 263;
          ac.push_back(static_cast<uint8_t>(7 | 0x80));
          ac.push_back(static_cast<uint8_t>(k - 8));
        }
        gap -= k * nslots;
      }
      while (gap > 8) {
        ac.push_back(7);
        gap -= 8;
      }
      if (d >= -14 && d <= 15) {
        ac.push_back(static_cast<uint8_t>((gap - 1) | ((d & 31) << 3)));
      } else {
        const int32_t cv = d > 127 ? 127 : (d < -127 ? -127 : d);
        ac.push_back(static_cast<uint8_t>((gap - 1) | ((17 & 31) << 3)));
        ac.push_back(static_cast<uint8_t>(static_cast<int8_t>(cv)));
        if (d != cv) {
          int64_t sg = pos - sprev;
          while (sg > 65535) {
            sgaps.push_back(65535);
            sdeltas.push_back(0);
            sg -= 65535;
          }
          sgaps.push_back(static_cast<uint16_t>(sg));
          sdeltas.push_back(static_cast<int16_t>(d - cv));
          sprev = pos;
        }
      }
      prev_pos = pos;
    }
    prev_mask[block] = mask & lim;
    return 0;
  }
};

// Seed a worker's temporal-predictor state by decoding the frame BEFORE its
// slice without emitting anything (the workers' buffers start zeroed, so
// only nonzeros need storing).
struct TDeltaSeedSink {
  static constexpr bool kZigzagOrder = true;
  int16_t* prev;
  uint64_t* prev_mask;
  int nslots = 64;

  inline int emit(int64_t block, const int16_t* scratch, uint64_t mask) {
    const uint64_t lim =
        nslots >= 64 ? ~0ull : ((1ull << nslots) - 1);
    uint64_t m = mask & lim;
    int16_t* pv = prev + block * 64;
    uint64_t mm = m;
    while (mm) {
      const int j = __builtin_ctzll(mm);
      mm &= mm - 1;
      pv[j] = scratch[j];
    }
    prev_mask[block] = m;
    return 0;
  }
};

// Decode the Y-component DCT coefficients of one baseline JPEG into `sink`.
// Blocks are emitted in flat row-major order regardless of the MCU
// interleave (4:2:0 decodes two block rows per MCU row): each MCU row is
// staged in `stage`/`stage_mask` (v0*bw blocks; caller-provided so a batch
// reuses one allocation) and flushed in order when complete. Returns 0 on
// success, negative error codes otherwise.
template <typename Sink>
static int decode_y(const uint8_t* data, int len, Sink& sink, int max_blocks,
                    int* out_meta, uint16_t* out_qtable,
                    std::vector<int16_t>* stage_buf,
                    std::vector<uint64_t>* stage_mask_buf) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  const uint8_t* p = data + 2;
  const uint8_t* end = data + len;

  uint16_t qtables[4][64];
  bool qseen[4] = {false, false, false, false};
  Huff huff_dc[4], huff_ac[4];
  Component comp[3];
  int ncomp = 0, width = 0, height = 0, restart_interval = 0;

  while (p + 4 <= end) {
    if (*p != 0xFF) return -2;
    if (p[1] == 0xFF) {  // fill-byte padding before a marker (T.81 B.1.1.2)
      ++p;
      continue;
    }
    uint8_t marker = p[1];
    p += 2;
    if (marker == 0xD9) return -3;           // EOI before SOS
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (p + 2 > end) return -2;
    const int seglen = rd16(p);
    const uint8_t* seg = p + 2;
    const uint8_t* segend = p + seglen;
    if (segend > end) return -2;

    switch (marker) {
      case 0xDB:  // DQT
        while (seg < segend) {
          const int pq = seg[0] >> 4, tq = seg[0] & 15;
          ++seg;
          if (tq > 3) return -4;
          // Bounds: a truncated segment must fail cleanly, not read past
          // the caller's buffer.
          if (seg + (pq ? 128 : 64) > segend) return -2;
          for (int i = 0; i < 64; ++i) {
            const int v = pq ? rd16(seg + 2 * i) : seg[i];
            qtables[tq][kZigzag[i]] = static_cast<uint16_t>(v);
          }
          qseen[tq] = true;
          seg += pq ? 128 : 64;
        }
        break;
      case 0xC0: {  // SOF0 baseline
        if (seg + 6 > segend) return -2;
        height = rd16(seg + 1);
        width = rd16(seg + 3);
        ncomp = seg[5];
        if (ncomp != 1 && ncomp != 3) return -5;
        if (seg + 6 + 3 * ncomp > segend) return -2;
        for (int c = 0; c < ncomp; ++c) {
          comp[c].id = seg[6 + 3 * c];
          comp[c].h = seg[7 + 3 * c] >> 4;
          comp[c].v = seg[7 + 3 * c] & 15;
          comp[c].tq = seg[8 + 3 * c];
          // tq indexes the 4-element qtables/qseen stack arrays; DQT
          // validates its own selector but SOF's was unchecked — an
          // out-of-range byte here read (and leaked) stack memory.
          if (comp[c].tq > 3) return -6;
          if (comp[c].h < 1 || comp[c].h > 2 || comp[c].v < 1 || comp[c].v > 2)
            return -6;
          if (c > 0 && (comp[c].h != 1 || comp[c].v != 1)) return -6;
        }
        break;
      }
      case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return -7;  // non-baseline SOF
      case 0xC4:  // DHT
        while (seg + 17 <= segend) {
          const int tc = seg[0] >> 4, th = seg[0] & 15;
          if (th > 3) return -8;
          int nsym = 0;
          for (int i = 0; i < 16; ++i) nsym += seg[1 + i];
          if (seg + 17 + nsym > segend || nsym > 256) return -8;
          if (!(tc ? huff_ac[th] : huff_dc[th]).build(seg + 1, seg + 17,
                                                      nsym))
            return -8;  // over-subscribed (non-Kraft) table
          seg += 17 + nsym;
        }
        break;
      case 0xDD:  // DRI
        if (seg + 2 > segend) return -2;
        restart_interval = rd16(seg);
        break;
      case 0xDA: {  // SOS — entropy-coded data follows
        if (seg + 1 > segend) return -2;
        const int ns = seg[0];
        if (ns != ncomp) return -9;  // only interleaved single-scan
        if (seg + 1 + 2 * ns > segend) return -2;
        for (int s = 0; s < ns; ++s) {
          const int cid = seg[1 + 2 * s];
          for (int c = 0; c < ncomp; ++c) {
            if (comp[c].id == cid) {
              comp[c].td = seg[2 + 2 * s] >> 4;
              comp[c].ta = seg[2 + 2 * s] & 15;
              // Selectors index 4-element stack arrays of Huff structs;
              // unchecked values read uninitialized memory whose decode
              // tables then drive wild indexed loads.
              if (comp[c].td > 3 || comp[c].ta > 3) return -9;
            }
          }
        }
        if (width <= 0 || height <= 0) return -10;
        if (!qseen[comp[0].tq]) return -10;

        // A single-component image is NON-interleaved per the spec
        // (A.2.2): the MCU is one data unit and the declared sampling
        // factors do not tile the luma into h0 x v0 MCU blocks. PIL emits
        // grayscale JPEGs with h=v=2 when asked for 4:2:0 subsampling;
        // libjpeg decodes them as plain ceil(w/8) x ceil(h/8) grids —
        // honoring the factors here produced a 2x2-interleaved misparse
        // (garbage frames, round-3 review).
        const int h0 = (ncomp == 1) ? 1 : comp[0].h;
        const int v0 = (ncomp == 1) ? 1 : comp[0].v;
        const int mcux = (width + 8 * h0 - 1) / (8 * h0);
        const int mcuy = (height + 8 * v0 - 1) / (8 * v0);
        const int bw = mcux * h0, bh = mcuy * v0;
        if (bw * bh > max_blocks) return kErrCapacity;

        out_meta[0] = width;
        out_meta[1] = height;
        out_meta[2] = bw;
        out_meta[3] = bh;
        for (int i = 0; i < 64; ++i) out_qtable[i] = qtables[comp[0].tq][i];

        // MCU-row staging (values need no zeroing — the mask guides reads).
        const size_t row_blocks = static_cast<size_t>(v0) * bw;
        if (stage_buf->size() < row_blocks * 64) stage_buf->resize(row_blocks * 64);
        if (stage_mask_buf->size() < row_blocks) stage_mask_buf->resize(row_blocks);
        int16_t* stage = stage_buf->data();
        uint64_t* stage_mask = stage_mask_buf->data();

        BitReader br(segend, end);
        int mcu_count = 0;
        int16_t chroma_scratch[64];
        for (int my = 0; my < mcuy; ++my) {
          std::memset(stage_mask, 0, row_blocks * sizeof(uint64_t));
          for (int mx = 0; mx < mcux; ++mx) {
            if (restart_interval && mcu_count == restart_interval) {
              if (!br.restart()) return -12;
              for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
              mcu_count = 0;
            }
            ++mcu_count;
            for (int c = 0; c < ncomp; ++c) {
              const Huff& hdc = huff_dc[comp[c].td];
              const Huff& hac = huff_ac[comp[c].ta];
              if (!hdc.ok || !hac.ok) return -13;
              const int nb = (c == 0) ? h0 * v0 : 1;
              for (int b = 0; b < nb; ++b) {
                int16_t* dst;
                uint64_t* msk = nullptr;
                if (c == 0) {
                  const size_t slot =
                      static_cast<size_t>(b / h0) * bw + (mx * h0 + b % h0);
                  dst = stage + slot * 64;
                  msk = stage_mask + slot;
                } else {
                  dst = chroma_scratch;
                }
                // DC
                const int t = hdc.decode(br);
                if (t < 0 || t > 15) return -14;
                comp[c].pred += br.receive_extend(t);
                if (msk && comp[c].pred != 0) {
                  dst[0] = static_cast<int16_t>(comp[c].pred);
                  *msk |= 1u;
                }
                // AC (values are nonzero by construction: s > 0 EXTENDs to
                // a value whose magnitude is at least 2^(s-1)).
                for (int k = 1; k < 64;) {
                  const int rs = hac.decode(br);
                  if (rs < 0) return -14;
                  const int r = rs >> 4, s = rs & 15;
                  if (s == 0) {
                    if (r != 15) break;  // EOB (ZRL otherwise)
                    k += 16;
                  } else {
                    k += r;
                    if (k > 63) return -14;
                    const int32_t v = br.receive_extend(s);
                    if (msk) {
                      // Sinks choose their block-slot order: NATURAL
                      // (de-zigzagged, what a dense tensor wants) or
                      // ZIGZAG (the scan's own order — run-lengths stay
                      // tiny, which the split transport's 3-bit gaps
                      // exploit; the device folds the inverse permutation
                      // into the IDCT basis matrix for free).
                      const int slot_k = Sink::kZigzagOrder ? k : kZigzag[k];
                      dst[slot_k] = static_cast<int16_t>(v);
                      *msk |= 1ull << slot_k;
                    }
                    ++k;
                  }
                }
              }
            }
          }
          // Flush the completed MCU row in flat row-major block order.
          for (int r = 0; r < v0; ++r) {
            const int64_t row_base = (static_cast<int64_t>(my) * v0 + r) * bw;
            for (int bx = 0; bx < bw; ++bx) {
              const int rc = sink.emit(row_base + bx, stage + (static_cast<size_t>(r) * bw + bx) * 64,
                                       stage_mask[static_cast<size_t>(r) * bw + bx]);
              if (rc < 0) return rc;
            }
          }
        }
        return 0;
      }
      default:
        break;  // APPn, COM, ...
    }
    p = segend;
  }
  return -15;  // no SOS found
}

}  // namespace

extern "C" {

// Decode the Y-component DCT coefficients of a baseline JPEG (DENSE).
//
//   data/len     : the JPEG bytes
//   out_coeffs   : int16 buffer for >= max_blocks * 64 values, filled with
//                  de-zigzagged quantized coefficients, block row-major
//   max_blocks   : capacity of out_coeffs in blocks
//   out_meta     : int32[4] = {width, height, blocks_wide, blocks_high}
//   out_qtable   : uint16[64] luma quantization table (natural order)
//
// Returns 0 on success, negative error codes otherwise (-11 = capacity,
// retryable with a larger buffer).
int vbs_jpeg_y_coeffs(const uint8_t* data, int len, int16_t* out_coeffs,
                      int max_blocks, int* out_meta, uint16_t* out_qtable) {
  // The memset covers the worst case (capacity); decode_y only writes the
  // nonzero coefficients on top.
  std::memset(out_coeffs, 0,
              static_cast<size_t>(max_blocks) * 64 * sizeof(int16_t));
  DenseSink sink{out_coeffs};
  std::vector<int16_t> stage;
  std::vector<uint64_t> stage_mask;
  return decode_y(data, len, sink, max_blocks, out_meta, out_qtable, &stage,
                  &stage_mask);
}

// Batch variant: decode `n` JPEGs (concatenated in `data` at `offsets`,
// sizes `sizes`) into one coefficient tensor. All frames must share
// identical geometry (an MJPEG stream does); frame 0's metadata is the
// contract. Quantization tables are PER FRAME (out_qtable is uint16[n*64]):
// MJPEG writers (cv2's included) adapt quality frame by frame. Returns the
// number of successfully decoded frames (stops at the first geometry
// mismatch or parse error).
int vbs_mjpeg_batch_y_coeffs(const uint8_t* data, const int64_t* offsets,
                             const int32_t* sizes, int n, int16_t* out_coeffs,
                             int blocks_per_frame, int* out_meta,
                             uint16_t* out_qtable) {
  int meta[4];
  std::vector<int16_t> stage;
  std::vector<uint64_t> stage_mask;
  std::memset(out_coeffs, 0, static_cast<size_t>(n) * blocks_per_frame * 64 *
                                 sizeof(int16_t));
  for (int i = 0; i < n; ++i) {
    DenseSink sink{out_coeffs + static_cast<size_t>(i) * blocks_per_frame * 64};
    const int rc = decode_y(data + offsets[i], sizes[i], sink,
                            blocks_per_frame, i == 0 ? out_meta : meta,
                            out_qtable + static_cast<size_t>(i) * 64, &stage,
                            &stage_mask);
    if (rc != 0) return i;
    // Full geometry equality: comparing only the block PRODUCT would
    // accept a mid-stream rotation/reshape (e.g. 640x480 -> 480x640) and
    // scramble the reassembled frames silently.
    if (i > 0 && (meta[0] != out_meta[0] || meta[1] != out_meta[1] ||
                  meta[2] != out_meta[2] || meta[3] != out_meta[3]))
      return i;
  }
  return n;
}

// DELTA batch variant: the sparse transport format (see file header).
//
//   out_gaps    : uint8[cap]  strictly-positive position deltas (+ fillers)
//   out_vals    : int8[cap]   clamped coefficients, same count as gaps
//   out_sgaps   : uint8[scap] spill-stream position deltas (+ fillers)
//   out_sdeltas : int16[scap] spill remainders (v - clamp(v))
//   out_counts  : int64[2] = {entries written, spill entries written}
//
// Returns n on success; a frame index 0 <= i < n at the first parse error
// or geometry mismatch; kErrValCap/kErrSpillCap (-100/-102) when a stream
// capacity is exceeded (retry with larger buffers).
int vbs_mjpeg_batch_y_coeffs_delta(const uint8_t* data,
                                   const int64_t* offsets,
                                   const int32_t* sizes, int n,
                                   uint8_t* out_gaps, int8_t* out_vals,
                                   int64_t cap, uint8_t* out_sgaps,
                                   int16_t* out_sdeltas, int64_t scap,
                                   int64_t* out_counts, int blocks_per_frame,
                                   int* out_meta, uint16_t* out_qtable) {
  int meta[4];
  DeltaSink sink{out_gaps, out_vals, cap, 0, out_sgaps, out_sdeltas, scap, 0};
  std::vector<int16_t> stage;
  std::vector<uint64_t> stage_mask;
  for (int i = 0; i < n; ++i) {
    sink.frame_base = static_cast<int64_t>(i) * blocks_per_frame * 64;
    const int rc = decode_y(data + offsets[i], sizes[i], sink,
                            blocks_per_frame, i == 0 ? out_meta : meta,
                            out_qtable + static_cast<size_t>(i) * 64, &stage,
                            &stage_mask);
    if (rc == kErrValCap || rc == kErrSpillCap) return rc;
    if (rc != 0) return i;
    if (i > 0 && (meta[0] != out_meta[0] || meta[1] != out_meta[1] ||
                  meta[2] != out_meta[2] || meta[3] != out_meta[3]))
      return i;
  }
  out_counts[0] = sink.n;
  out_counts[1] = sink.sn;
  return n;
}

// Multithreaded DELTA batch variant. Frames are independent (MJPEG), so the
// batch splits into contiguous frame slices decoded on `n_threads` worker
// threads into thread-local growable buffers; the main thread then stitches
// the slices into the caller's single packed stream. Each worker encodes
// gaps relative to its slice's flat base − 1; stitching re-bases a slice by
// adding the bridge distance (slice base − 1 − previous slice's last
// position) to the slice's FIRST gap — positions are cumulative, so every
// later position shifts with it — emitting (255, 0) fillers for any excess,
// exactly the in-stream long-run rule. Output is byte-identical semantics
// to the serial variant (same positions, values, spills; filler placement
// may differ at slice joins, which the pre-zeroed scatter absorbs).
//
// Same return protocol as the serial variant. On a 1-core host call the
// serial path (n_threads <= 1 short-circuits to it).
int vbs_mjpeg_batch_y_coeffs_delta_mt(
    const uint8_t* data, const int64_t* offsets, const int32_t* sizes, int n,
    uint8_t* out_gaps, int8_t* out_vals, int64_t cap, uint8_t* out_sgaps,
    int16_t* out_sdeltas, int64_t scap, int64_t* out_counts,
    int blocks_per_frame, int* out_meta, uint16_t* out_qtable,
    int n_threads) {
  if (n_threads > n - 1) n_threads = n - 1;
  if (n_threads > 64) n_threads = 64;
  if (n_threads <= 1 || n < 4)
    return vbs_mjpeg_batch_y_coeffs_delta(data, offsets, sizes, n, out_gaps,
                                          out_vals, cap, out_sgaps,
                                          out_sdeltas, scap, out_counts,
                                          blocks_per_frame, out_meta,
                                          out_qtable);

  // Frame 0 decodes serially into the caller's buffers: it establishes the
  // geometry contract the workers validate against.
  DeltaSink sink{out_gaps, out_vals, cap, 0, out_sgaps, out_sdeltas, scap, 0};
  {
    std::vector<int16_t> stage;
    std::vector<uint64_t> stage_mask;
    const int rc = decode_y(data + offsets[0], sizes[0], sink,
                            blocks_per_frame, out_meta, out_qtable, &stage,
                            &stage_mask);
    if (rc == kErrValCap || rc == kErrSpillCap) return rc;
    if (rc != 0) return 0;
  }

  struct Slice {
    int a = 0, b = 0;  // global frame range [a, b)
    DeltaVecSink sink;
    int fail = -1;     // global index of the first failed frame, -1 = ok
  };
  std::vector<Slice> slices(n_threads);
  const int rest = n - 1;  // frames 1..n-1
  for (int t = 0; t < n_threads; ++t) {
    slices[t].a = 1 + static_cast<int>(static_cast<int64_t>(rest) * t /
                                       n_threads);
    slices[t].b = 1 + static_cast<int>(static_cast<int64_t>(rest) * (t + 1) /
                                       n_threads);
  }

  const int64_t frame_coeffs = static_cast<int64_t>(blocks_per_frame) * 64;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    Slice* s = &slices[t];
    workers.emplace_back([=]() {
      int meta_l[4];
      std::vector<int16_t> stage;
      std::vector<uint64_t> stage_mask;
      s->sink.prev = static_cast<int64_t>(s->a) * frame_coeffs - 1;
      s->sink.sprev = s->sink.prev;
      // Typical sparsity reservation avoids early regrowth churn.
      s->sink.gaps.reserve(static_cast<size_t>(s->b - s->a) *
                           blocks_per_frame * 6);
      s->sink.vals.reserve(s->sink.gaps.capacity());
      for (int i = s->a; i < s->b; ++i) {
        s->sink.frame_base = static_cast<int64_t>(i) * frame_coeffs;
        const int rc = decode_y(data + offsets[i], sizes[i], s->sink,
                                blocks_per_frame, meta_l,
                                out_qtable + static_cast<size_t>(i) * 64,
                                &stage, &stage_mask);
        if (rc != 0 || meta_l[0] != out_meta[0] || meta_l[1] != out_meta[1] ||
            meta_l[2] != out_meta[2] || meta_l[3] != out_meta[3]) {
          s->fail = i;
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  for (const auto& s : slices)
    if (s.fail >= 0) return s.fail;  // slices are ordered: first failure

  // Stitch the two streams (main + spill) slice by slice.
  int64_t nmain = sink.n, nspill = sink.sn;
  int64_t prev = sink.prev, sprev = sink.sprev;
  for (auto& s : slices) {
    const int64_t base_prev = static_cast<int64_t>(s.a) * frame_coeffs - 1;
    if (!s.sink.gaps.empty()) {
      int64_t g = static_cast<int64_t>(s.sink.gaps[0]) + (base_prev - prev);
      while (g > 255) {
        if (nmain >= cap) return kErrValCap;
        out_gaps[nmain] = 255;
        out_vals[nmain] = 0;
        ++nmain;
        g -= 255;
      }
      const int64_t cnt = static_cast<int64_t>(s.sink.gaps.size());
      if (nmain + cnt > cap) return kErrValCap;
      out_gaps[nmain] = static_cast<uint8_t>(g);
      out_vals[nmain] = s.sink.vals[0];
      ++nmain;
      std::memcpy(out_gaps + nmain, s.sink.gaps.data() + 1, cnt - 1);
      std::memcpy(out_vals + nmain, s.sink.vals.data() + 1, cnt - 1);
      nmain += cnt - 1;
      prev = s.sink.prev;
    }
    if (!s.sink.sgaps.empty()) {
      int64_t g = static_cast<int64_t>(s.sink.sgaps[0]) + (base_prev - sprev);
      while (g > 255) {
        if (nspill >= scap) return kErrSpillCap;
        out_sgaps[nspill] = 255;
        out_sdeltas[nspill] = 0;
        ++nspill;
        g -= 255;
      }
      const int64_t cnt = static_cast<int64_t>(s.sink.sgaps.size());
      if (nspill + cnt > scap) return kErrSpillCap;
      out_sgaps[nspill] = static_cast<uint8_t>(g);
      out_sdeltas[nspill] = s.sink.sdeltas[0];
      ++nspill;
      std::memcpy(out_sgaps + nspill, s.sink.sgaps.data() + 1, cnt - 1);
      std::memcpy(out_sdeltas + nspill, s.sink.sdeltas.data() + 1,
                  (cnt - 1) * sizeof(int16_t));
      nspill += cnt - 1;
      sprev = s.sink.sprev;
    }
  }
  out_counts[0] = nmain;
  out_counts[1] = nspill;
  return n;
}

// SPLIT batch variant: DC/AC-separated transport (see SplitSink) — the
// lowest-byte lossless format for link-bound host->TPU ingest.
//
//   out_ac      : uint8[ac_cap] AC entry bytes (gap-1 | code<<3; SHORT/
//                 EXT/escape framing per the SplitSink header)
//   out_dc      : uint8[n * ceil(blocks_per_frame/2)] per-block DC delta
//                 nibble lane (keyframe-spatial / temporal prediction)
//   out_sgaps/out_sdeltas : AC spill stream (uint16 gaps over AC positions)
//   out_dgaps/out_ddeltas : DC spill stream (uint16 gaps over block indices)
//   out_counts  : int64[3] = {ac bytes, AC spills, DC spills}
//   zmax        : 2..64 — AC zigzag indices >= zmax are dropped and the
//                 position space is zmax-1 slots/block (64 = lossless;
//                 see SplitSink header). Out-of-range values clamp to 64.
//
// Returns n on success; a frame index 0 <= i < n at the first parse error
// or geometry mismatch; kErrAcCap/kErrAcSpillCap/kErrDcSpillCap
// (-104/-105/-106) when a stream capacity is exceeded (retry larger).
// Multi-core hosts use the _split_mt variant below.
int vbs_mjpeg_batch_y_coeffs_split(
    const uint8_t* data, const int64_t* offsets, const int32_t* sizes, int n,
    uint8_t* out_ac, int64_t ac_cap, uint8_t* out_dc, uint16_t* out_sgaps,
    int16_t* out_sdeltas, int64_t scap, uint16_t* out_dgaps,
    int16_t* out_ddeltas, int64_t dcap, int64_t* out_counts,
    int blocks_per_frame, int* out_meta, uint16_t* out_qtable, int zmax) {
  if (zmax < 2 || zmax > 64) zmax = 64;
  int meta[4];
  SplitSink sink{out_ac,    ac_cap, 0,    out_dc,    out_sgaps,
                 out_sdeltas, scap, 0,    out_dgaps, out_ddeltas,
                 dcap,      0};
  sink.nslots = zmax - 1;
  sink.blocks_per_frame = blocks_per_frame;
  std::vector<int32_t> cdc(static_cast<size_t>(blocks_per_frame), 0);
  std::vector<int32_t> pdc(static_cast<size_t>(blocks_per_frame), 0);
  sink.cur_frame_dc = cdc.data();
  sink.prev_frame_dc = pdc.data();
  std::vector<int16_t> stage;
  std::vector<uint64_t> stage_mask;
  for (int i = 0; i < n; ++i) {
    sink.frame_block_base = static_cast<int64_t>(i) * blocks_per_frame;
    sink.frame_index = i;
    const int rc = decode_y(data + offsets[i], sizes[i], sink,
                            blocks_per_frame, i == 0 ? out_meta : meta,
                            out_qtable + static_cast<size_t>(i) * 64, &stage,
                            &stage_mask);
    if (rc == kErrAcCap || rc == kErrAcSpillCap || rc == kErrDcSpillCap)
      return rc;
    if (rc != 0) return i;
    if (i > 0 && (meta[0] != out_meta[0] || meta[1] != out_meta[1] ||
                  meta[2] != out_meta[2] || meta[3] != out_meta[3]))
      return i;
    const int frc = sink.flush_dc();
    if (frc < 0) return frc;
  }
  out_counts[0] = sink.ac_n;
  out_counts[1] = sink.sn;
  out_counts[2] = sink.dn;
  return n;
}

// Multithreaded SPLIT batch variant (see the _delta_mt stitcher for the
// slicing model). Frames are independent, so the batch splits into
// contiguous frame slices decoded on worker threads. Stitching is SIMPLER
// than delta's:
//  * DC nibbles write directly into the caller's lane (frame lanes are
//    whole disjoint bytes) — no stitching. The per-frame predictor FLAG
//    makes slices self-contained: workers t > 0 simply encode their first
//    frame spatially (the encoder's always-available choice); worker 0
//    starts at frame 1 and inherits frame 0's absolute DCs from the
//    serial frame-0 decode, so it keeps the temporal option. Decoded
//    output is identical to the serial variant's; slice-start frames may
//    pick a different (still exact) predictor, so lane BYTES may differ.
//  * AC byte slices are kept VERBATIM: a slice encodes its first gap
//    relative to its base position (a*blocks*63 - 1), so the main thread
//    only emits BRIDGE bytes (escapes + zero-value fillers) advancing from
//    the previous slice's last position exactly to that base, then memcpys
//    the slice. Bridge fillers land value-0 entries on true-zero slots of
//    the pre-zeroed target — harmless by construction.
//  * Spill slices re-base their FIRST gap (positions are cumulative),
//    with (65535, 0) fillers for any excess — the in-stream long-run rule.
// Output is semantically identical to the serial variant (same positions,
// values, spills; bridge-filler placement differs at slice joins).
//
// Same return protocol as the serial variant; n_threads <= 1 or tiny
// batches short-circuit to it.
int vbs_mjpeg_batch_y_coeffs_split_mt(
    const uint8_t* data, const int64_t* offsets, const int32_t* sizes, int n,
    uint8_t* out_ac, int64_t ac_cap, uint8_t* out_dc, uint16_t* out_sgaps,
    int16_t* out_sdeltas, int64_t scap, uint16_t* out_dgaps,
    int16_t* out_ddeltas, int64_t dcap, int64_t* out_counts,
    int blocks_per_frame, int* out_meta, uint16_t* out_qtable, int zmax,
    int n_threads) {
  if (zmax < 2 || zmax > 64) zmax = 64;
  const int nslots = zmax - 1;
  if (n_threads > n - 1) n_threads = n - 1;
  if (n_threads > 64) n_threads = 64;
  if (n_threads <= 1 || n < 4)
    return vbs_mjpeg_batch_y_coeffs_split(data, offsets, sizes, n, out_ac,
                                          ac_cap, out_dc, out_sgaps,
                                          out_sdeltas, scap, out_dgaps,
                                          out_ddeltas, dcap, out_counts,
                                          blocks_per_frame, out_meta,
                                          out_qtable, zmax);

  // Frame 0 decodes serially into the caller's buffers: it establishes the
  // geometry contract the workers validate against, and its absolute DCs
  // seed worker 0's temporal predictor.
  SplitSink sink{out_ac,    ac_cap, 0,    out_dc,    out_sgaps,
                 out_sdeltas, scap, 0,    out_dgaps, out_ddeltas,
                 dcap,      0};
  sink.nslots = nslots;
  sink.blocks_per_frame = blocks_per_frame;
  std::vector<int32_t> frame0_cur(static_cast<size_t>(blocks_per_frame), 0);
  std::vector<int32_t> frame0_dc(static_cast<size_t>(blocks_per_frame), 0);
  sink.cur_frame_dc = frame0_cur.data();
  sink.prev_frame_dc = frame0_dc.data();
  {
    std::vector<int16_t> stage;
    std::vector<uint64_t> stage_mask;
    sink.frame_block_base = 0;
    sink.frame_index = 0;
    const int rc = decode_y(data + offsets[0], sizes[0], sink,
                            blocks_per_frame, out_meta, out_qtable, &stage,
                            &stage_mask);
    if (rc == kErrAcCap || rc == kErrAcSpillCap || rc == kErrDcSpillCap)
      return rc;
    if (rc != 0) return 0;
    const int frc = sink.flush_dc();  // leaves frame 0's DCs in frame0_dc
    if (frc < 0) return frc;
  }

  struct Slice {
    int a = 0, b = 0;  // global frame range [a, b)
    SplitVecSink sink;
    int fail = -1;
  };
  std::vector<Slice> slices(n_threads);
  const int rest = n - 1;
  for (int t = 0; t < n_threads; ++t) {
    slices[t].a = 1 + static_cast<int>(static_cast<int64_t>(rest) * t /
                                       n_threads);
    slices[t].b = 1 + static_cast<int>(static_cast<int64_t>(rest) * (t + 1) /
                                       n_threads);
  }

  const int64_t bpf = blocks_per_frame;
  const int64_t bpf2 = (bpf + 2) / 2;  // nibble lane bytes per frame
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    Slice* s = &slices[t];
    const int32_t* seed = (t == 0) ? frame0_dc.data() : nullptr;
    workers.emplace_back([=]() {
      if (s->a >= s->b) return;
      int meta_l[4];
      std::vector<int16_t> stage;
      std::vector<uint64_t> stage_mask;
      s->sink.nslots = nslots;
      s->sink.blocks_per_frame = static_cast<int>(bpf);
      s->sink.slice_start = s->a;
      s->sink.dc = out_dc + static_cast<int64_t>(s->a) * bpf2;
      s->sink.cur_frame_dc.assign(static_cast<size_t>(bpf), 0);
      if (seed) {  // worker 0 starts at frame 1: temporal vs frame 0
        s->sink.prev_frame_dc.assign(seed, seed + bpf);
        s->sink.have_prev = true;
      } else {     // others' first frame encodes spatially (have_prev off)
        s->sink.prev_frame_dc.assign(static_cast<size_t>(bpf), 0);
      }
      s->sink.prev_ac = static_cast<int64_t>(s->a) * bpf * nslots - 1;
      s->sink.sprev = s->sink.prev_ac;
      s->sink.dprev = static_cast<int64_t>(s->a) * bpf - 1;
      s->sink.ac.reserve(static_cast<size_t>(s->b - s->a) * bpf * 5);
      for (int i = s->a; i < s->b; ++i) {
        s->sink.frame_block_base = static_cast<int64_t>(i) * bpf;
        s->sink.frame_index = i;
        const int rc = decode_y(data + offsets[i], sizes[i], s->sink, bpf,
                                meta_l,
                                out_qtable + static_cast<size_t>(i) * 64,
                                &stage, &stage_mask);
        if (rc != 0 || meta_l[0] != out_meta[0] || meta_l[1] != out_meta[1] ||
            meta_l[2] != out_meta[2] || meta_l[3] != out_meta[3]) {
          s->fail = i;
          return;
        }
        s->sink.flush_dc();  // vector-backed: cannot fail
      }
    });
  }
  for (auto& w : workers) w.join();
  for (const auto& s : slices)
    if (s.fail >= 0) return s.fail;  // slices are ordered: first failure

  int64_t ac_n = sink.ac_n, sn = sink.sn, dn = sink.dn;
  int64_t prev_ac = sink.prev_ac, sprev = sink.sprev, dprev = sink.dprev;
  for (auto& s : slices) {
    const int64_t base_ac = static_cast<int64_t>(s.a) * bpf * nslots - 1;
    if (!s.sink.ac.empty()) {
      int64_t bridge = base_ac - prev_ac;  // >= 0
      while (bridge >= nslots) {
        int64_t k = bridge / nslots;
        if (k > 8) k = 8;
        if (ac_n >= ac_cap) return kErrAcCap;
        out_ac[ac_n++] = static_cast<uint8_t>((k - 1) | 0x80);
        bridge -= k * nslots;
      }
      while (bridge > 0) {
        const int64_t g = bridge > 8 ? 8 : bridge;
        if (ac_n >= ac_cap) return kErrAcCap;
        out_ac[ac_n++] = static_cast<uint8_t>(g - 1);  // value 0
        bridge -= g;
      }
      if (ac_n + static_cast<int64_t>(s.sink.ac.size()) > ac_cap)
        return kErrAcCap;
      std::memcpy(out_ac + ac_n, s.sink.ac.data(), s.sink.ac.size());
      ac_n += static_cast<int64_t>(s.sink.ac.size());
      prev_ac = s.sink.prev_ac;
    }
    if (!s.sink.sgaps.empty()) {
      int64_t g = static_cast<int64_t>(s.sink.sgaps[0]) + (base_ac - sprev);
      while (g > 65535) {
        if (sn >= scap) return kErrAcSpillCap;
        out_sgaps[sn] = 65535;
        out_sdeltas[sn] = 0;
        ++sn;
        g -= 65535;
      }
      const int64_t cnt = static_cast<int64_t>(s.sink.sgaps.size());
      if (sn + cnt > scap) return kErrAcSpillCap;
      out_sgaps[sn] = static_cast<uint16_t>(g);
      out_sdeltas[sn] = s.sink.sdeltas[0];
      ++sn;
      std::memcpy(out_sgaps + sn, s.sink.sgaps.data() + 1,
                  (cnt - 1) * sizeof(uint16_t));
      std::memcpy(out_sdeltas + sn, s.sink.sdeltas.data() + 1,
                  (cnt - 1) * sizeof(int16_t));
      sn += cnt - 1;
      sprev = s.sink.sprev;
    }
    if (!s.sink.dgaps.empty()) {
      const int64_t base_dc = static_cast<int64_t>(s.a) * bpf - 1;
      int64_t g = static_cast<int64_t>(s.sink.dgaps[0]) + (base_dc - dprev);
      while (g > 65535) {
        if (dn >= dcap) return kErrDcSpillCap;
        out_dgaps[dn] = 65535;
        out_ddeltas[dn] = 0;
        ++dn;
        g -= 65535;
      }
      const int64_t cnt = static_cast<int64_t>(s.sink.dgaps.size());
      if (dn + cnt > dcap) return kErrDcSpillCap;
      out_dgaps[dn] = static_cast<uint16_t>(g);
      out_ddeltas[dn] = s.sink.ddeltas[0];
      ++dn;
      std::memcpy(out_dgaps + dn, s.sink.dgaps.data() + 1,
                  (cnt - 1) * sizeof(uint16_t));
      std::memcpy(out_ddeltas + dn, s.sink.ddeltas.data() + 1,
                  (cnt - 1) * sizeof(int16_t));
      dn += cnt - 1;
      dprev = s.sink.dprev;
    }
  }
  out_counts[0] = ac_n;
  out_counts[1] = sn;
  out_counts[2] = dn;
  return n;
}

// TDELTA batch variant: temporal-delta transport (see TDeltaSink) — the
// lowest-byte lossless format for the production workload (a static camera
// watching a slowly-deforming gel: ~96% of blocks are bit-identical frame
// to frame, benchmarks/README.md round 5).
//
//   out_ac      : uint8[ac_cap] VLC entry bytes (SHORT/EXT/escape framing
//                 per the TDeltaSink header; slot 0 = DC)
//   out_sgaps/out_sdeltas : spill stream (uint16 gaps over positions /
//                 int16 remainders for |delta| > 127)
//   out_counts  : int64[2] = {ac bytes, spills}
//   zmax        : 2..64 — zigzag slots >= zmax ignored on both sides of
//                 the delta (64 = lossless; clamped otherwise)
//
// Returns n on success; a frame index 0 <= i < n at the first parse error
// or geometry mismatch; kErrAcCap/kErrAcSpillCap (-104/-105) when a stream
// capacity is exceeded (retry larger). Frame 0 deltas against all-zeros
// (absolute), so every batch is self-contained.
int vbs_mjpeg_batch_y_coeffs_tdelta(
    const uint8_t* data, const int64_t* offsets, const int32_t* sizes, int n,
    uint8_t* out_ac, int64_t ac_cap, uint16_t* out_sgaps,
    int16_t* out_sdeltas, int64_t scap, int64_t* out_counts,
    int blocks_per_frame, int* out_meta, uint16_t* out_qtable, int zmax) {
  if (zmax < 2 || zmax > 64) zmax = 64;
  int meta[4];
  std::vector<int16_t> prev(static_cast<size_t>(blocks_per_frame) * 64, 0);
  std::vector<uint64_t> pmask(static_cast<size_t>(blocks_per_frame), 0);
  TDeltaSink sink{out_ac, ac_cap, 0, out_sgaps, out_sdeltas, scap, 0};
  sink.nslots = zmax;
  sink.prev = prev.data();
  sink.prev_mask = pmask.data();
  std::vector<int16_t> stage;
  std::vector<uint64_t> stage_mask;
  for (int i = 0; i < n; ++i) {
    sink.frame_block_base = static_cast<int64_t>(i) * blocks_per_frame;
    const int rc = decode_y(data + offsets[i], sizes[i], sink,
                            blocks_per_frame, i == 0 ? out_meta : meta,
                            out_qtable + static_cast<size_t>(i) * 64, &stage,
                            &stage_mask);
    if (rc == kErrAcCap || rc == kErrAcSpillCap) return rc;
    if (rc != 0) return i;
    if (i > 0 && (meta[0] != out_meta[0] || meta[1] != out_meta[1] ||
                  meta[2] != out_meta[2] || meta[3] != out_meta[3]))
      return i;
  }
  out_counts[0] = sink.ac_n;
  out_counts[1] = sink.sn;
  return n;
}

// Multithreaded TDELTA batch variant. The temporal predictor chains frames,
// so slices are NOT independent: each worker first decodes the frame BEFORE
// its slice into its predictor state (TDeltaSeedSink — decode only, no
// emission; one extra Huffman decode per worker), then encodes its slice's
// deltas exactly as the serial sink would. Stitching bridges the single
// stream's position gaps with escapes/fillers like the split stitcher; the
// decoded output is bitwise-identical to the serial variant's.
//
// Same return protocol as the serial variant; n_threads <= 1 or tiny
// batches short-circuit to it.
int vbs_mjpeg_batch_y_coeffs_tdelta_mt(
    const uint8_t* data, const int64_t* offsets, const int32_t* sizes, int n,
    uint8_t* out_ac, int64_t ac_cap, uint16_t* out_sgaps,
    int16_t* out_sdeltas, int64_t scap, int64_t* out_counts,
    int blocks_per_frame, int* out_meta, uint16_t* out_qtable, int zmax,
    int n_threads) {
  if (zmax < 2 || zmax > 64) zmax = 64;
  const int nslots = zmax;
  if (n_threads > n - 1) n_threads = n - 1;
  if (n_threads > 64) n_threads = 64;
  if (n_threads <= 1 || n < 4)
    return vbs_mjpeg_batch_y_coeffs_tdelta(data, offsets, sizes, n, out_ac,
                                           ac_cap, out_sgaps, out_sdeltas,
                                           scap, out_counts, blocks_per_frame,
                                           out_meta, out_qtable, zmax);

  // Frame 0 decodes serially into the caller's buffers: it establishes the
  // geometry contract the workers validate against.
  std::vector<int16_t> prev0(static_cast<size_t>(blocks_per_frame) * 64, 0);
  std::vector<uint64_t> pmask0(static_cast<size_t>(blocks_per_frame), 0);
  TDeltaSink sink{out_ac, ac_cap, 0, out_sgaps, out_sdeltas, scap, 0};
  sink.nslots = nslots;
  sink.prev = prev0.data();
  sink.prev_mask = pmask0.data();
  {
    std::vector<int16_t> stage;
    std::vector<uint64_t> stage_mask;
    sink.frame_block_base = 0;
    const int rc = decode_y(data + offsets[0], sizes[0], sink,
                            blocks_per_frame, out_meta, out_qtable, &stage,
                            &stage_mask);
    if (rc == kErrAcCap || rc == kErrAcSpillCap) return rc;
    if (rc != 0) return 0;
  }

  struct Slice {
    int a = 0, b = 0;  // global frame range [a, b)
    TDeltaVecSink sink;
    int fail = -1;
  };
  std::vector<Slice> slices(n_threads);
  const int rest = n - 1;
  for (int t = 0; t < n_threads; ++t) {
    slices[t].a = 1 + static_cast<int>(static_cast<int64_t>(rest) * t /
                                       n_threads);
    slices[t].b = 1 + static_cast<int>(static_cast<int64_t>(rest) * (t + 1) /
                                       n_threads);
  }

  const int64_t bpf = blocks_per_frame;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    Slice* s = &slices[t];
    workers.emplace_back([=]() {
      if (s->a >= s->b) return;
      int meta_l[4];
      uint16_t qt_l[64];
      std::vector<int16_t> stage;
      std::vector<uint64_t> stage_mask;
      s->sink.nslots = nslots;
      s->sink.prev.assign(static_cast<size_t>(bpf) * 64, 0);
      s->sink.prev_mask.assign(static_cast<size_t>(bpf), 0);
      // Seed the temporal predictor: decode frame a-1 without emitting.
      // (Worker 0's seed is frame 0, re-decoded here — cheaper than
      // sharing prev0 across threads and identical by determinism.)
      {
        TDeltaSeedSink seed{s->sink.prev.data(), s->sink.prev_mask.data(),
                            nslots};
        const int rc = decode_y(data + offsets[s->a - 1], sizes[s->a - 1],
                                seed, static_cast<int>(bpf), meta_l, qt_l,
                                &stage, &stage_mask);
        if (rc != 0) {
          s->fail = s->a - 1;
          return;
        }
      }
      s->sink.prev_pos = static_cast<int64_t>(s->a) * bpf * nslots - 1;
      s->sink.sprev = s->sink.prev_pos;
      s->sink.ac.reserve(static_cast<size_t>(s->b - s->a) * bpf / 2);
      for (int i = s->a; i < s->b; ++i) {
        s->sink.frame_block_base = static_cast<int64_t>(i) * bpf;
        const int rc = decode_y(data + offsets[i], sizes[i], s->sink,
                                static_cast<int>(bpf), meta_l,
                                out_qtable + static_cast<size_t>(i) * 64,
                                &stage, &stage_mask);
        if (rc != 0 || meta_l[0] != out_meta[0] || meta_l[1] != out_meta[1] ||
            meta_l[2] != out_meta[2] || meta_l[3] != out_meta[3]) {
          s->fail = i;
          return;
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  for (const auto& s : slices)
    if (s.fail >= 0) return s.fail;  // slices are ordered: first failure

  // Stitch: bridge position gaps between slices with escapes (2-byte form
  // for long runs), then memcpy the slice's bytes verbatim; re-base each
  // spill slice's first gap (positions are cumulative).
  int64_t ac_n = sink.ac_n, sn = sink.sn;
  int64_t prev_pos = sink.prev_pos, sprev = sink.sprev;
  for (auto& s : slices) {
    const int64_t base_pos = static_cast<int64_t>(s.a) * bpf * nslots - 1;
    if (!s.sink.ac.empty()) {
      int64_t bridge = base_pos - prev_pos;  // >= 0
      while (bridge >= nslots) {
        int64_t k = bridge / nslots;
        if (k <= 7) {
          if (ac_n >= ac_cap) return kErrAcCap;
          out_ac[ac_n++] = static_cast<uint8_t>((k - 1) | 0x80);
        } else {
          if (k > 263) k = 263;
          if (ac_n + 2 > ac_cap) return kErrAcCap;
          out_ac[ac_n++] = static_cast<uint8_t>(7 | 0x80);
          out_ac[ac_n++] = static_cast<uint8_t>(k - 8);
        }
        bridge -= k * nslots;
      }
      while (bridge > 0) {
        const int64_t g = bridge > 8 ? 8 : bridge;
        if (ac_n >= ac_cap) return kErrAcCap;
        out_ac[ac_n++] = static_cast<uint8_t>(g - 1);  // value 0
        bridge -= g;
      }
      if (ac_n + static_cast<int64_t>(s.sink.ac.size()) > ac_cap)
        return kErrAcCap;
      std::memcpy(out_ac + ac_n, s.sink.ac.data(), s.sink.ac.size());
      ac_n += static_cast<int64_t>(s.sink.ac.size());
      prev_pos = s.sink.prev_pos;
    }
    if (!s.sink.sgaps.empty()) {
      int64_t g = static_cast<int64_t>(s.sink.sgaps[0]) + (base_pos - sprev);
      while (g > 65535) {
        if (sn >= scap) return kErrAcSpillCap;
        out_sgaps[sn] = 65535;
        out_sdeltas[sn] = 0;
        ++sn;
        g -= 65535;
      }
      const int64_t cnt = static_cast<int64_t>(s.sink.sgaps.size());
      if (sn + cnt > scap) return kErrAcSpillCap;
      out_sgaps[sn] = static_cast<uint16_t>(g);
      out_sdeltas[sn] = s.sink.sdeltas[0];
      ++sn;
      std::memcpy(out_sgaps + sn, s.sink.sgaps.data() + 1,
                  (cnt - 1) * sizeof(uint16_t));
      std::memcpy(out_sdeltas + sn, s.sink.sdeltas.data() + 1,
                  (cnt - 1) * sizeof(int16_t));
      sn += cnt - 1;
      sprev = s.sink.sprev;
    }
  }
  out_counts[0] = ac_n;
  out_counts[1] = sn;
  return n;
}

}  // extern "C"
