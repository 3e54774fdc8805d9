// Zstandard decoder (RFC 8878), CRC-32C and XXH64, with a plain C
// interface for ctypes (segfusion_tpu_torch/utils/zstd.py).
//
// Decodes every frame of a buffer: raw, RLE and compressed blocks;
// literals raw, RLE, Huffman-coded in one or four streams and treeless;
// sequences with predefined, RLE, FSE-compressed and repeated tables;
// repeat offsets; skippable frames; the XXH64 content checksum where a
// frame carries one. Frames that need a dictionary are refused. Any
// malformed input makes the entry point return -1 with a message.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 zstd.cpp -o libzstd_port.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Error(what); }

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

uint64_t le_n(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// -- XXH64 -------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}
uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

uint64_t xxh64_impl(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ uint64_t(le32(p)) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// -- CRC-32C -----------------------------------------------------------------

struct CrcTable {
  uint32_t t[8][256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (c & 1 ? 0x82F63B78u : 0);
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (uint32_t i = 0; i < 256; ++i)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};
const CrcTable crc_table;

uint32_t crc32c_impl(uint32_t crc, const uint8_t* p, size_t n) {
  const auto& t = crc_table.t;
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {  // slicing by 8
    uint64_t v = le64(p) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; n; --n, ++p) crc = t[0][(crc ^ *p) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// -- output ------------------------------------------------------------------

struct Out {
  uint8_t* p = nullptr;
  size_t n = 0, cap = 0;
  bool growable = false;

  void reserve(size_t extra) {
    if (n + extra <= cap) return;
    if (!growable) fail("output larger than the buffer given");
    if (extra > (size_t(1) << 48)) fail("output too large");
    size_t c = cap ? cap : 1 << 16;
    while (c < n + extra) c *= 2;
    auto* q = static_cast<uint8_t*>(std::realloc(p, c));
    if (!q) fail("out of memory");
    p = q;
    cap = c;
  }
  void put(const uint8_t* s, size_t k) {
    reserve(k);
    if (k) std::memcpy(p + n, s, k);
    n += k;
  }
  void fill(uint8_t b, size_t k) {
    reserve(k);
    std::memset(p + n, b, k);
    n += k;
  }
};

// -- bit streams ---------------------------------------------------------------

// Forward little-endian bits (FSE table descriptions).
struct Forward {
  const uint8_t* p;
  size_t n, bit = 0;
  uint32_t peek(int k) const {  // k <= 24
    uint64_t v = 0;
    size_t byte = bit >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t(v >> (bit & 7)) & ((1u << k) - 1);
  }
};

// Backward bits: from under the last byte's highest set bit down to bit 0;
// bits below 0 read as zeros (pos goes negative: overflow).
struct Backward {
  const uint8_t* p;
  int64_t pos;
  Backward(const uint8_t* data, size_t n) : p(data) {
    if (n == 0 || data[n - 1] == 0) fail("bit stream lacks its end marker");
    pos = int64_t(8 * (n - 1)) + highbit(data[n - 1]);
  }
  uint64_t read(int k) {  // k <= 56
    if (k == 0) return 0;
    int64_t low = pos - k;
    uint64_t v = 0;
    if (pos > 0) {
      if (low >= 0) {
        int64_t b0 = low >> 3, b1 = (pos + 7) >> 3;
        for (int64_t b = b1 - 1; b >= b0; --b) v = v << 8 | p[b];
        v >>= (low & 7);
      } else {
        int64_t b1 = (pos + 7) >> 3;
        for (int64_t b = b1 - 1; b >= 0; --b) v = v << 8 | p[b];
        v <<= -low;
      }
    }
    pos = low;
    return v & ((uint64_t(1) << k) - 1);
  }
};

// -- FSE ---------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct Fse {
  int log = -1;  // -1: none yet
  std::vector<FseEntry> t;
};

void fse_build(Fse& f, const int16_t* probs, int nsym, int log) {
  int size = 1 << log, high = size - 1;
  f.log = log;
  f.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  for (int s = 0; s < nsym; ++s) {
    if (probs[s] == -1) {
      f.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(probs[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, pos = 0;
  for (int s = 0; s < nsym; ++s)
    for (int i = 0; i < probs[s]; ++i) {
      f.t[pos].symbol = uint16_t(s);
      do pos = (pos + step) & (size - 1);
      while (pos > high);
    }
  if (pos != 0) fail("FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    uint32_t n = next[f.t[u].symbol]++;
    int nb = log - highbit(n);
    f.t[u].nbits = uint8_t(nb);
    f.t[u].base = uint16_t((n << nb) - size);
  }
}

// Reads a table description at p[0:n]; returns the bytes read.
size_t fse_describe(Fse& f, const uint8_t* p, size_t n, int max_symbol,
                    int max_log) {
  if (n == 0) fail("truncated FSE description");
  Forward in{p, n};
  int log = int(in.peek(4)) + 5;
  if (log > max_log) fail("FSE accuracy log too large");
  in.bit = 4;
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int16_t probs[256];
  int nsym = 0;
  while (remaining > 1) {
    if (nsym > max_symbol) fail("FSE description has too many symbols");
    int mx = 2 * threshold - 1 - remaining;
    int count;
    int low = int(in.peek(24)) & (threshold - 1);
    if (low < mx) {
      count = low;
      in.bit += nb - 1;
    } else {
      count = int(in.peek(24)) & (2 * threshold - 1);
      if (count >= threshold) count -= mx;
      in.bit += nb;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    probs[nsym++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        int rep = int(in.peek(2));
        in.bit += 2;
        if (nsym + rep > max_symbol + 1) fail("FSE description has too many symbols");
        for (int i = 0; i < rep; ++i) probs[nsym++] = 0;
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
    if (in.bit > 8 * n) fail("truncated FSE description");
  }
  if (remaining != 1 || nsym > max_symbol + 1) fail("corrupt FSE description");
  fse_build(f, probs, nsym, log);
  return (in.bit + 7) / 8;
}

// -- Huffman -----------------------------------------------------------------

struct Huffman {
  int max_bits = 0;  // 0: none yet
  std::vector<uint8_t> symbol, nbits;
};

size_t huffman_describe(Huffman& h, const uint8_t* p, size_t n) {
  if (n == 0) fail("truncated Huffman tree description");
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  int head = p[0];
  if (head >= 128) {
    nw = head - 127;
    size_t bytes = size_t(nw + 1) / 2;
    if (1 + bytes > n) fail("truncated Huffman weights");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = i % 2 ? b & 15 : b >> 4;
    }
    used = 1 + bytes;
  } else {
    if (size_t(1 + head) > n) fail("truncated Huffman weights");
    Fse f;
    size_t d = fse_describe(f, p + 1, head, 255, 6);
    if (d > size_t(head)) fail("truncated Huffman weights");
    Backward bits(p + 1 + d, head - d);
    uint32_t s1 = uint32_t(bits.read(f.log)), s2 = uint32_t(bits.read(f.log));
    for (;;) {
      if (nw > 253) fail("too many Huffman weights");
      const FseEntry& e1 = f.t[s1];
      weights[nw++] = uint8_t(e1.symbol);
      s1 = e1.base + uint32_t(bits.read(e1.nbits));
      if (bits.pos < 0) {
        weights[nw++] = uint8_t(f.t[s2].symbol);
        break;
      }
      const FseEntry& e2 = f.t[s2];
      weights[nw++] = uint8_t(e2.symbol);
      s2 = e2.base + uint32_t(bits.read(e2.nbits));
      if (bits.pos < 0) {
        weights[nw++] = uint8_t(f.t[s1].symbol);
        break;
      }
    }
    used = 1 + size_t(head);
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("empty Huffman tree");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a tree");
  weights[nw++] = uint8_t(highbit(rest) + 1);
  h.max_bits = max_bits;
  h.symbol.assign(size_t(1) << max_bits, 0);
  h.nbits.assign(size_t(1) << max_bits, 0);
  size_t pos = 0;
  for (int w = 1; w <= max_bits; ++w)
    for (int s = 0; s < nw; ++s)
      if (weights[s] == w) {
        size_t k = size_t(1) << (w - 1);
        std::memset(&h.symbol[pos], s, k);
        std::memset(&h.nbits[pos], max_bits + 1 - w, k);
        pos += k;
      }
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* p, size_t n, uint8_t* out,
                    size_t count) {
  Backward bits(p, n);
  const int mb = h.max_bits;
  const uint8_t* sym = h.symbol.data();
  const uint8_t* nb = h.nbits.data();
  for (size_t i = 0; i < count; ++i) {
    if (bits.pos < 0) fail("Huffman stream overrun");
    // peek max_bits without consuming, then consume the code's length
    int64_t low = bits.pos - mb;
    uint32_t v;
    if (low >= 0) {
      int64_t b1 = (bits.pos + 7) >> 3, b0 = low >> 3;
      uint32_t x = 0;
      for (int64_t b = b1 - 1; b >= b0; --b) x = x << 8 | p[b];
      v = (x >> (low & 7)) & ((1u << mb) - 1);
    } else {
      uint32_t x = 0;
      for (int64_t b = ((bits.pos + 7) >> 3) - 1; b >= 0; --b) x = x << 8 | p[b];
      v = (x << -low) & ((1u << mb) - 1);
    }
    out[i] = sym[v];
    bits.pos -= nb[v];
  }
  if (bits.pos != 0) fail("Huffman stream not consumed exactly");
}

// -- sequences -----------------------------------------------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                              10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                              24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,   17,   18,   19,  20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,   35,   37,   39,  41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  Huffman huffman;
  Fse ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

size_t seq_table(Fse& f, int mode, const uint8_t* p, size_t n, int max_symbol,
                 int max_log, const int16_t* def, int ndef, int deflog) {
  switch (mode) {
    case 0:
      fse_build(f, def, ndef, deflog);
      return 0;
    case 1:
      if (n == 0) fail("truncated RLE sequence code");
      if (p[0] > max_symbol) fail("sequence code out of range");
      f.log = 0;
      f.t.assign(1, FseEntry{p[0], 0, 0});
      return 1;
    case 2:
      return fse_describe(f, p, n, max_symbol, max_log);
    default:
      if (f.log < 0) fail("repeat mode without a previous table");
      return 0;
  }
}

size_t literals(const uint8_t* p, size_t n, FrameState& st) {
  if (n == 0) fail("truncated literals header");
  int kind = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (kind < 2) {
    size_t size, head;
    if (fmt == 0 || fmt == 2) {
      size = p[0] >> 3;
      head = 1;
    } else if (fmt == 1) {
      if (n < 2) fail("truncated literals header");
      size = (p[0] >> 4) + (size_t(p[1]) << 4);
      head = 2;
    } else {
      if (n < 3) fail("truncated literals header");
      size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      head = 3;
    }
    if (kind == 0) {
      if (head + size > n) fail("truncated raw literals");
      st.lits.assign(p + head, p + head + size);
      return head + size;
    }
    if (head + 1 > n) fail("truncated RLE literals");
    st.lits.assign(size, p[head]);
    return head + 1;
  }
  static const int HEAD[4] = {3, 3, 4, 5}, BITS[4] = {10, 10, 14, 18};
  size_t head = HEAD[fmt];
  if (head > n) fail("truncated literals header");
  uint64_t h = le_n(p, int(head));
  uint64_t mask = (uint64_t(1) << BITS[fmt]) - 1;
  size_t regen = (h >> 4) & mask, comp = (h >> (4 + BITS[fmt])) & mask;
  if (head + comp > n) fail("truncated compressed literals");
  const uint8_t* q = p + head;
  const uint8_t* stop = q + comp;
  if (kind == 2) q += huffman_describe(st.huffman, q, comp);
  else if (st.huffman.max_bits == 0) fail("treeless literals without a previous tree");
  if (q > stop) fail("truncated compressed literals");
  st.lits.resize(regen);
  if (fmt == 0) {
    huffman_stream(st.huffman, q, size_t(stop - q), st.lits.data(), regen);
  } else {
    if (q + 6 > stop) fail("truncated jump table");
    size_t s1 = q[0] | q[1] << 8, s2 = q[2] | q[3] << 8, s3 = q[4] | q[5] << 8;
    q += 6;
    if (q + s1 + s2 + s3 > stop) fail("corrupt jump table");
    size_t quarter = (regen + 3) / 4;
    if (3 * quarter > regen) fail("corrupt literals size");
    const uint8_t* b[5] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3, stop};
    for (int i = 0; i < 4; ++i)
      huffman_stream(st.huffman, b[i], size_t(b[i + 1] - b[i]),
                     st.lits.data() + i * quarter,
                     i < 3 ? quarter : regen - 3 * quarter);
  }
  return head + comp;
}

void block(const uint8_t* p, size_t n, FrameState& st, Out& out, size_t frame_start) {
  size_t pos = literals(p, n, st);
  if (pos >= n) fail("block lacks its sequences section");
  uint32_t nseq;
  uint8_t b0 = p[pos];
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > n) fail("truncated sequences header");
    nseq = ((b0 - 128u) << 8) + p[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail("truncated sequences header");
    nseq = p[pos + 1] + (uint32_t(p[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  const uint8_t* lits = st.lits.data();
  size_t nlits = st.lits.size();
  if (nseq == 0) {
    if (pos != n) fail("bytes after an empty sequences section");
    out.put(lits, nlits);
    return;
  }
  if (pos >= n) fail("truncated sequences header");
  uint8_t modes = p[pos++];
  if (modes & 3) fail("reserved bits set in the sequence modes");
  pos += seq_table(st.ll, modes >> 6, p + pos, n - pos, 35, 9, LL_DEFAULT, 36, 6);
  pos += seq_table(st.of, (modes >> 4) & 3, p + pos, n - pos, 31, 8, OF_DEFAULT, 29, 5);
  pos += seq_table(st.ml, (modes >> 2) & 3, p + pos, n - pos, 52, 9, ML_DEFAULT, 53, 6);
  if (pos > n) fail("truncated sequence tables");
  Backward bits(p + pos, n - pos);
  uint32_t sll = uint32_t(bits.read(st.ll.log));
  uint32_t sof = uint32_t(bits.read(st.of.log));
  uint32_t sml = uint32_t(bits.read(st.ml.log));
  uint64_t* rep = st.rep;
  size_t lit = 0;
  for (uint32_t i = 0; i < nseq; ++i) {
    const FseEntry& eo = st.of.t[sof];
    const FseEntry& em = st.ml.t[sml];
    const FseEntry& el = st.ll.t[sll];
    uint32_t ofc = eo.symbol;
    if (ofc > 31) fail("offset code above 31");
    uint64_t ofv = (uint64_t(1) << ofc) + bits.read(int(ofc));
    uint64_t mlen = ML_BASE[em.symbol] + bits.read(ML_BITS[em.symbol]);
    uint64_t llen = LL_BASE[el.symbol] + bits.read(LL_BITS[el.symbol]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      uint64_t idx = ofv - 1 + (llen == 0);
      if (idx == 0) {
        offset = rep[0];
      } else if (idx == 1) {
        offset = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        offset = idx == 2 ? rep[2] : rep[0] - 1;
        if (offset == 0) fail("repeat offset of 0");
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (llen > nlits - lit) fail("sequence overruns the literals");
    out.put(lits + lit, llen);
    lit += llen;
    if (offset > out.n - frame_start) fail("match offset before the frame start");
    out.reserve(mlen);
    uint8_t* d = out.p + out.n;
    const uint8_t* s = d - offset;
    if (offset >= mlen) {
      std::memcpy(d, s, mlen);
    } else {
      for (uint64_t k = 0; k < mlen; ++k) d[k] = s[k];
    }
    out.n += mlen;
    if (i + 1 != nseq) {
      sll = el.base + uint32_t(bits.read(el.nbits));
      sml = em.base + uint32_t(bits.read(em.nbits));
      sof = eo.base + uint32_t(bits.read(eo.nbits));
    }
  }
  if (bits.pos != 0) fail("sequence bit stream not consumed exactly");
  out.put(lits + lit, nlits - lit);
}

size_t frame(const uint8_t* p, size_t n, Out& out) {
  size_t start = out.n, pos = 0;
  if (n < 1) fail("truncated frame header");
  uint8_t fhd = p[pos++];
  if (fhd & 8) fail("reserved bit set in the frame header");
  int single = fhd >> 5 & 1;
  if (!single) ++pos;  // window descriptor
  static const int DID[4] = {0, 1, 2, 4};
  int did_size = DID[fhd & 3];
  int fcs_size = (fhd >> 6) == 0 ? single : 1 << (fhd >> 6);
  if (pos + did_size + fcs_size > n) fail("truncated frame header");
  if (le_n(p + pos, did_size)) fail("frame needs a dictionary; dictionaries are not supported");
  pos += did_size;
  bool has_size = fcs_size > 0;
  uint64_t content = le_n(p + pos, fcs_size) + (fcs_size == 2 ? 256 : 0);
  pos += fcs_size;
  // a block of at least 3 bytes regenerates at most 128 KiB
  if (has_size && content / 131072 > n / 3 + 1) fail("frame content size exceeds what its blocks can hold");
  if (has_size) out.reserve(content);
  FrameState st;
  for (;;) {
    if (pos + 3 > n) fail("truncated block header");
    uint32_t h = uint32_t(le_n(p + pos, 3));
    pos += 3;
    uint32_t last = h & 1, kind = (h >> 1) & 3, size = h >> 3;
    if (kind == 0) {
      if (pos + size > n) fail("truncated raw block");
      out.put(p + pos, size);
      pos += size;
    } else if (kind == 1) {
      if (pos >= n) fail("truncated RLE block");
      out.fill(p[pos], size);
      pos += 1;
    } else if (kind == 2) {
      if (pos + size > n || size == 0) fail("truncated compressed block");
      block(p + pos, size, st, out, start);
      pos += size;
    } else {
      fail("reserved block type");
    }
    if (last) break;
  }
  if (has_size && out.n - start != content) fail("frame size differs from its header");
  if (fhd & 4) {
    if (pos + 4 > n) fail("truncated checksum");
    uint32_t want = le32(p + pos);
    pos += 4;
    if (uint32_t(xxh64_impl(out.p + start, out.n - start, 0)) != want)
      fail("content checksum mismatch");
  }
  return pos;
}

void decompress(const uint8_t* p, size_t n, Out& out) {
  size_t pos = 0;
  while (pos < n) {
    if (pos + 4 > n) fail("truncated frame magic");
    uint32_t magic = le32(p + pos);
    pos += 4;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (pos + 4 > n) fail("truncated skippable frame");
      uint64_t skip = le32(p + pos);
      pos += 4;
      if (pos + skip > n) fail("truncated skippable frame");
      pos += skip;
    } else if (magic == 0xFD2FB528u) {
      pos += frame(p + pos, n - pos, out);
    } else {
      fail("unknown frame magic");
    }
  }
}

void set_error(char* err, int64_t cap, const char* msg) {
  if (err && cap > 0) {
    std::strncpy(err, msg, size_t(cap) - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes every frame of src into dst (capacity cap): the decoded size,
// or -1 with a message in err.
int64_t zstd_decompress_into(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap, char* err, int64_t errcap) {
  Out out;
  out.p = dst;
  out.cap = size_t(cap);
  try {
    decompress(src, size_t(n), out);
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -1;
  }
  return int64_t(out.n);
}

// As zstd_decompress_into, into a buffer it allocates (*dst, released
// with zstd_free, also after an error).
int64_t zstd_decompress_alloc(const uint8_t* src, int64_t n, uint8_t** dst,
                              char* err, int64_t errcap) {
  Out out;
  out.growable = true;
  int64_t r;
  try {
    out.reserve(std::min<size_t>(size_t(n) * 4, size_t(1) << 20) + 1);
    decompress(src, size_t(n), out);
    r = int64_t(out.n);
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    r = -1;
  }
  *dst = out.p;
  return r;
}

void zstd_free(void* p) { std::free(p); }

uint32_t crc32c(uint32_t crc, const uint8_t* p, int64_t n) {
  return crc32c_impl(crc, p, size_t(n));
}

uint64_t xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  return xxh64_impl(p, size_t(n), seed);
}

}  // extern "C"
