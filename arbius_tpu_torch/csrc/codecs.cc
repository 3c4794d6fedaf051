// arbius native codec core — deterministic DEFLATE (fixed Huffman).
//
// Byte-identical by specification to arbius_tpu/codecs/deflate.py (see its
// module docstring for the spec). The Python module is the readable
// reference; this is the hot path the node uses to encode PNG/IDAT for
// every solved task. Cross-equivalence is asserted by
// tests/test_codecs.py::test_native_matches_python.
//
// Build: g++ -O2 -shared -fPIC -o build/libarbius_codecs.so codecs.cc
// (done automatically by arbius_tpu/codecs/_native.py on first import).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kWindow = 32768;
constexpr int kMaxChain = 32;
constexpr int kHashBits = 15;

struct LenEntry { uint16_t code; uint8_t extra; uint16_t base; };
constexpr LenEntry kLenBases[] = {
    {257,0,3},{258,0,4},{259,0,5},{260,0,6},{261,0,7},{262,0,8},{263,0,9},
    {264,0,10},{265,1,11},{266,1,13},{267,1,15},{268,1,17},{269,2,19},
    {270,2,23},{271,2,27},{272,2,31},{273,3,35},{274,3,43},{275,3,51},
    {276,3,59},{277,4,67},{278,4,83},{279,4,99},{280,4,115},{281,5,131},
    {282,5,163},{283,5,195},{284,5,227},{285,0,258},
};
struct DistEntry { uint16_t code; uint8_t extra; uint16_t base; };
constexpr DistEntry kDistBases[] = {
    {0,0,1},{1,0,2},{2,0,3},{3,0,4},{4,1,5},{5,1,7},{6,2,9},{7,2,13},
    {8,3,17},{9,3,25},{10,4,33},{11,4,49},{12,5,65},{13,5,97},{14,6,129},
    {15,6,193},{16,7,257},{17,7,385},{18,8,513},{19,8,769},{20,9,1025},
    {21,9,1537},{22,10,2049},{23,10,3073},{24,11,4097},{25,11,6145},
    {26,12,8193},{27,12,12289},{28,13,16385},{29,13,24577},
};

struct BitWriter {
  uint8_t* out;
  size_t cap;
  size_t pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  void bits(uint32_t value, int n) {
    acc |= value << nbits;
    nbits += n;
    while (nbits >= 8) {
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = static_cast<uint8_t>(acc & 0xFF);
      acc >>= 8;
      nbits -= 8;
    }
  }
  void huff(uint32_t code, int n) {
    uint32_t rev = 0;
    for (int i = 0; i < n; i++) { rev = (rev << 1) | (code & 1); code >>= 1; }
    bits(rev, n);
  }
  size_t finish() {
    if (nbits) {
      if (pos >= cap) { overflow = true; return 0; }
      out[pos++] = static_cast<uint8_t>(acc & 0xFF);
      acc = 0; nbits = 0;
    }
    return pos;
  }
};

inline void fixed_litlen(int sym, uint32_t* code, int* n) {
  if (sym <= 143)      { *code = 0x30 + sym;          *n = 8; }
  else if (sym <= 255) { *code = 0x190 + (sym - 144); *n = 9; }
  else if (sym <= 279) { *code = sym - 256;           *n = 7; }
  else                 { *code = 0xC0 + (sym - 280);  *n = 8; }
}

inline uint32_t hash3(const uint8_t* d, size_t i) {
  uint32_t word = (uint32_t(d[i]) << 16) | (uint32_t(d[i + 1]) << 8) | d[i + 2];
  return (word * 2654435761u) >> (32 - kHashBits);
}

}  // namespace

extern "C" {

// Returns bytes written, or 0 if out_cap is too small.
size_t arbius_deflate_fixed(const uint8_t* data, size_t n,
                            uint8_t* out, size_t out_cap) {
  BitWriter w{out, out_cap};
  w.bits(1, 1);  // BFINAL
  w.bits(1, 2);  // BTYPE=01

  std::vector<int64_t> head(size_t(1) << kHashBits, -1);
  std::vector<int64_t> prev(kWindow, -1);

  // length -> (code, extra bits, extra value base) lookup
  static uint16_t len_code[kMaxMatch + 1];
  static uint8_t len_extra[kMaxMatch + 1];
  static uint16_t len_base[kMaxMatch + 1];
  static bool init = false;
  if (!init) {
    for (int length = kMinMatch; length <= kMaxMatch; length++) {
      for (int i = int(sizeof(kLenBases) / sizeof(LenEntry)) - 1; i >= 0; i--) {
        if (length >= kLenBases[i].base) {
          len_code[length] = kLenBases[i].code;
          len_extra[length] = kLenBases[i].extra;
          len_base[length] = kLenBases[i].base;
          break;
        }
      }
    }
    init = true;
  }

  size_t i = 0;
  while (i < n) {
    int match_len = 0;
    int64_t match_dist = 0;
    if (i + kMinMatch <= n) {
      int64_t cand = head[hash3(data, i)];
      int chain = 0;
      int limit = int(n - i < size_t(kMaxMatch) ? n - i : kMaxMatch);
      while (cand >= 0 && int64_t(i) - cand <= kWindow && chain < kMaxChain) {
        if (match_len == 0 ||
            (match_len < limit && data[cand + match_len] == data[i + match_len])) {
          int length = 0;
          while (length < limit && data[cand + length] == data[i + length])
            length++;
          if (length > match_len) {
            match_len = length;
            match_dist = int64_t(i) - cand;
            if (length == limit) break;
          }
        }
        cand = prev[cand % kWindow];
        chain++;
      }
    }
    if (match_len >= kMinMatch) {
      uint32_t code; int cn;
      fixed_litlen(len_code[match_len], &code, &cn);
      w.huff(code, cn);
      if (len_extra[match_len])
        w.bits(uint32_t(match_len - len_base[match_len]), len_extra[match_len]);
      int di = int(sizeof(kDistBases) / sizeof(DistEntry)) - 1;
      while (match_dist < kDistBases[di].base) di--;
      w.huff(kDistBases[di].code, 5);
      if (kDistBases[di].extra)
        w.bits(uint32_t(match_dist - kDistBases[di].base), kDistBases[di].extra);
      size_t end = i + match_len;
      while (i < end) {
        if (i + kMinMatch <= n) {
          uint32_t h = hash3(data, i);
          prev[i % kWindow] = head[h];
          head[h] = int64_t(i);
        }
        i++;
      }
    } else {
      uint32_t code; int cn;
      fixed_litlen(data[i], &code, &cn);
      w.huff(code, cn);
      if (i + kMinMatch <= n) {
        uint32_t h = hash3(data, i);
        prev[i % kWindow] = head[h];
        head[h] = int64_t(i);
      }
      i++;
    }
    if (w.overflow) return 0;
  }
  uint32_t code; int cn;
  fixed_litlen(256, &code, &cn);
  w.huff(code, cn);
  size_t written = w.finish();
  return w.overflow ? 0 : written;
}

}  // extern "C"
