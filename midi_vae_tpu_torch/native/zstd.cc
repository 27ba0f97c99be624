// zstd — a zstd frame decoder (RFC 8878) and CRC32C (Castagnoli) for the
// PyTorch port's reader of the JAX package's Orbax checkpoints
// (io/ocdbt.py, io/zarr2.py). Every byte of such a directory is
// zstd-compressed: the OCDBT manifests and b-tree nodes, and each zarr
// chunk; every OCDBT file ends in a CRC32C of what precedes it.
//
// What it decodes: raw, RLE and compressed blocks; literals that are raw,
// RLE or Huffman-coded (one or four streams, the tree described directly
// or through FSE-coded weights, and the treeless repeat of the previous
// tree); sequences whose tables are predefined, RLE, FSE-described or
// repeated; the three repeat offsets; several frames in a row and
// skippable frames. A frame's XXH64 content checksum is verified when it
// has one, and its Frame_Content_Size when present. A dictionary ID, a
// reserved bit or block type, a table that does not add up, a bitstream
// not consumed exactly, an offset before the frame's start, or input that
// ends early fails with the reason: nothing is ever returned short.
//
// C ABI (ctypes):
//   int      zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
//                            size_t* out_len, char* err, size_t err_cap)
//            — 0 and a malloc'd *out (free with zstd_free), or 1 and the
//              reason in err
//   void     zstd_free(uint8_t*)
//   uint32_t crc32c(const uint8_t* p, size_t n)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& why) { throw DecodeError(why); }

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint64_t load_le(const uint8_t* p, size_t n) {  // n <= 8
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full, P3 = 0x165667B19E3779F9ull,
                   P4 = 0x85EBCA77C2B2AE63ull, P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64_impl(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, load_le(p, 8)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- CRC32C

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

uint32_t crc32c_impl(const uint8_t* p, size_t n) {
  static const Crc32cTable T;
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {  // slicing by 8
    uint64_t w = load_le(p, 8) ^ c;
    c = T.t[7][w & 0xff] ^ T.t[6][(w >> 8) & 0xff] ^ T.t[5][(w >> 16) & 0xff] ^ T.t[4][(w >> 24) & 0xff] ^
        T.t[3][(w >> 32) & 0xff] ^ T.t[2][(w >> 40) & 0xff] ^ T.t[1][(w >> 48) & 0xff] ^ T.t[0][w >> 56];
  }
  for (; n; --n, ++p) c = (c >> 8) ^ T.t[0][(c ^ *p) & 0xff];
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- bit readers

// A backward bitstream (Huffman streams, FSE-coded weights, sequences): the
// last byte's highest set bit marks its end; values are read from the end
// towards the start, most recently written bits first. `c` holds the eight
// bytes from `ptr` with the next unread bit `used` bits below its top
// (bytes before the start of a short stream are zeros), so a peek is two
// shifts and a refill one load. Bits before the start read as zeros and
// drive left() negative, which callers check.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t ptr = 0;
  uint64_t c = 0;
  int used = 0;
  int pad = 0;  // zero bits below the start in c (a stream under 8 bytes)

  void init(const uint8_t* src, size_t size, const char* what) {
    if (size == 0) fail(std::string(what) + ": empty bitstream");
    const uint8_t last = src[size - 1];
    if (last == 0) fail(std::string(what) + ": bitstream has no end mark");
    p = src;
    if (size >= 8) {
      ptr = size - 8;
      std::memcpy(&c, src + ptr, 8);
      pad = 0;
    } else {
      ptr = 0;
      pad = 8 * int(8 - size);
      c = load_le(src, size) << pad;
    }
    used = 8 - highbit32(last);
  }
  int64_t left() const { return int64_t(ptr) * 8 + 64 - pad - used; }
  // move the window back over the bytes read; afterwards used <= 7 unless
  // the window already starts at the stream's start
  inline void refill() {
    if (ptr == 0) return;
    size_t bytes = size_t(used >> 3);
    if (bytes > ptr) bytes = ptr;
    ptr -= bytes;
    used -= int(8 * bytes);
    std::memcpy(&c, p + ptr, 8);
  }
  inline uint64_t peek(int nbits) const {  // 1 <= nbits, used + nbits <= 64 after a refill
    return used >= 64 ? 0 : (c << used) >> (64 - nbits);
  }
  inline uint64_t read(int nbits) {
    if (nbits == 0) return 0;
    refill();
    const uint64_t v = peek(nbits);
    used += nbits;
    return v;
  }
};

// ---------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

void fse_build(FseTable& T, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  T.log = log;
  T.t.assign(size, FseEntry{0, 0, 0});
  uint16_t next[256];
  int64_t high = int64_t(size) - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("FSE table: more low-probability symbols than states");
      T.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t position = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      T.t[position].symbol = uint16_t(s);
      do position = (position + step) & mask;
      while (int64_t(position) > high);
    }
  }
  if (position != 0) fail("FSE table: its probabilities do not spread over the table");
  for (uint32_t u = 0; u < size; ++u) {
    const uint32_t x = next[T.t[u].symbol]++;
    const int nb = log - highbit32(x);
    T.t[u].nbits = uint8_t(nb);
    T.t[u].base = uint16_t((x << nb) - size);
  }
}

void fse_single(FseTable& T, int symbol) {
  T.log = 0;
  T.t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

// An FSE table description (forward bitstream): the normalized counts of
// up to maxsym+1 symbols at an accuracy of at most maxlog. Returns the bytes
// it took.
size_t fse_read(FseTable& T, int maxsym, int maxlog, const uint8_t* src, size_t n, const char* what) {
  if (n == 0) fail(std::string(what) + ": truncated FSE table description");
  const uint64_t nbits_in = uint64_t(n) * 8;
  uint64_t bitpos = 0;
  auto peek = [&](int nb) -> uint32_t {  // zeros past the end; the caller checks bitpos
    uint64_t v = 0;
    size_t byte = size_t(bitpos >> 3);
    if (byte < n) v = load_le(src + byte, std::min<size_t>(8, n - byte)) >> (bitpos & 7);
    return uint32_t(v & ((uint64_t(1) << nb) - 1));
  };
  const int log = (src[0] & 15) + 5;
  if (log > maxlog) fail(std::string(what) + ": FSE accuracy log " + std::to_string(log) + " above its maximum");
  bitpos = 4;
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, s = 0;
  bool prev0 = false;
  while (remaining > 1 && s <= maxsym) {
    if (prev0) {
      int n0 = s;
      for (;;) {
        uint32_t r = peek(2);
        bitpos += 2;
        if (bitpos > nbits_in) fail(std::string(what) + ": truncated FSE table description");
        n0 += int(r);
        if (r != 3) break;
      }
      if (n0 > maxsym) fail(std::string(what) + ": FSE table description has too many symbols");
      s = n0;
    }
    const int max = (2 * threshold - 1) - remaining;
    uint32_t bits = peek(nb);
    int count;
    if (int(bits & uint32_t(threshold - 1)) < max) {
      count = int(bits & uint32_t(threshold - 1));
      bitpos += nb - 1;
    } else {
      count = int(bits & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      bitpos += nb;
    }
    if (bitpos > nbits_in) fail(std::string(what) + ": truncated FSE table description");
    --count;
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    prev0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = highbit32(uint32_t(remaining)) + 1;
      threshold = 1 << (nb - 1);
    }
  }
  if (remaining != 1) fail(std::string(what) + ": FSE probabilities do not add up");
  fse_build(T, norm, s, log);
  return size_t((bitpos + 7) >> 3);
}

// ---------------------------------------------------------------- Huffman

struct Huffman {
  int maxbits = 0;
  std::vector<uint16_t> t;  // symbol | nbits << 8, indexed by the next maxbits bits
};

// The tree description of a compressed literals section; returns its bytes.
size_t huffman_read(Huffman& H, const uint8_t* src, size_t n) {
  if (n == 0) fail("Huffman tree description: truncated");
  uint8_t w[256];
  int nw = 0;
  size_t used;
  const int hdr = src[0];
  if (hdr >= 128) {  // weights stored directly, 4 bits each
    nw = hdr - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) fail("Huffman tree description: truncated");
    for (int i = 0; i < nw; ++i) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
  } else {  // FSE-coded weights: two states interleaved over one stream
    const size_t csize = size_t(hdr);
    if (csize == 0 || 1 + csize > n) fail("Huffman tree description: truncated FSE-coded weights");
    FseTable T;
    const size_t head = fse_read(T, 255, 6, src + 1, csize, "Huffman weights");
    if (head >= csize) fail("Huffman weights: no bitstream after the FSE table");
    BackBits b;
    b.init(src + 1 + head, csize - head, "Huffman weights");
    uint32_t s1 = uint32_t(b.read(T.log)), s2 = uint32_t(b.read(T.log));
    if (b.left() < 0) fail("Huffman weights: bitstream too short");
    for (;;) {
      if (nw > 253) fail("Huffman weights: more than 255 weights");
      w[nw++] = uint8_t(T.t[s1].symbol);
      s1 = T.t[s1].base + uint32_t(b.read(T.t[s1].nbits));
      if (b.left() < 0) {
        w[nw++] = uint8_t(T.t[s2].symbol);
        break;
      }
      if (nw > 253) fail("Huffman weights: more than 255 weights");
      w[nw++] = uint8_t(T.t[s2].symbol);
      s2 = T.t[s2].base + uint32_t(b.read(T.t[s2].nbits));
      if (b.left() < 0) {
        w[nw++] = uint8_t(T.t[s1].symbol);
        break;
      }
    }
    used = 1 + csize;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("Huffman tree description: weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman tree description: all weights zero");
  const int maxbits = highbit32(total) + 1;
  if (maxbits > 11) fail("Huffman tree description: codes longer than 11 bits");
  const uint32_t rest = (1u << maxbits) - total;
  if (rest & (rest - 1)) fail("Huffman tree description: weights do not complete a prefix code");
  w[nw++] = uint8_t(highbit32(rest) + 1);  // the last symbol's implied weight
  H.maxbits = maxbits;
  H.t.assign(size_t(1) << maxbits, 0);
  size_t at = 0;
  for (int weight = 1; weight <= maxbits; ++weight) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != weight) continue;
      const size_t len = size_t(1) << (weight - 1);
      const uint16_t e = uint16_t(s | ((maxbits + 1 - weight) << 8));
      for (size_t k = 0; k < len; ++k) H.t[at + k] = e;
      at += len;
    }
  }
  return used;
}

// L Huffman streams decoded in lockstep (one, or the four of a four-stream
// section), so the lanes' table lookups overlap. While every window is
// away from its stream's start, four codes of at most 11 bits fit each
// refilled window; the tails take the guarded peek.
template <int L>
void huffman_lanes(const Huffman& H, const uint8_t* const* src, const size_t* n, uint8_t* const* out,
                   const size_t* count) {
  BackBits b[L];
  size_t common = count[0];
  for (int k = 0; k < L; ++k) {
    b[k].init(src[k], n[k], "Huffman literals stream");
    common = std::min(common, count[k]);
  }
  const uint16_t* t = H.t.data();
  const int mb = H.maxbits, shift = 64 - mb;
  // the lanes' windows in locals: the byte stores below may alias any memory
  // the compiler cannot see is private, and would reload them every code
  const uint8_t* base[L];
  uint8_t* dst[L];
  uint64_t c[L];
  size_t ptr[L];
  int used[L];
  for (int k = 0; k < L; ++k) {
    base[k] = b[k].p;
    dst[k] = out[k];
    c[k] = b[k].c;
    ptr[k] = b[k].ptr;
    used[k] = b[k].used;
  }
  size_t i = 0;
  for (; i + 4 <= common; i += 4) {
    bool near_start = false;
    for (int k = 0; k < L; ++k) {
      const size_t bytes = std::min(size_t(used[k] >> 3), ptr[k]);
      ptr[k] -= bytes;
      used[k] -= int(8 * bytes);
      std::memcpy(&c[k], base[k] + ptr[k], 8);
      near_start |= ptr[k] == 0;
    }
    if (near_start) break;
    for (int j = 0; j < 4; ++j) {
      for (int k = 0; k < L; ++k) {
        const uint16_t e = t[(c[k] << used[k]) >> shift];
        dst[k][i + j] = uint8_t(e & 0xff);
        used[k] += e >> 8;
      }
    }
  }
  for (int k = 0; k < L; ++k) {
    b[k].c = c[k];
    b[k].ptr = ptr[k];
    b[k].used = used[k];
  }
  for (int k = 0; k < L; ++k) {
    for (size_t m = i; m < count[k]; ++m) {
      b[k].refill();
      const uint16_t e = t[b[k].peek(mb)];
      out[k][m] = uint8_t(e & 0xff);
      b[k].used += e >> 8;
    }
    if (b[k].left() != 0) fail("Huffman literals stream: not consumed exactly");
  }
}

// ---------------------------------------------------------------- sequences

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,   12,   13,   14,    15,    16,    18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// The decoded bytes: malloc'd, grown geometrically without zero-filling,
// and handed to the caller as they are.
struct Output {
  uint8_t* data = nullptr;
  size_t size = 0, cap = 0;
  ~Output() { std::free(data); }
  void reserve(size_t n) {
    if (n <= cap) return;
    const size_t grown = std::max(n, cap + cap / 2);
    uint8_t* p = static_cast<uint8_t*>(std::realloc(data, grown ? grown : 1));
    if (!p) fail("out of memory");
    data = p;
    cap = grown;
  }
  uint8_t* release() {
    uint8_t* p = data;
    data = nullptr;
    size = cap = 0;
    return p;
  }
};

struct FrameState {
  Huffman huffman;
  bool have_huffman = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

// One sequence table by its mode: predefined, RLE, FSE-described, repeat.
void sequence_table(int mode, FseTable& T, bool& have, const int16_t* def, int defsym, int deflog, int maxsym,
                    int maxlog, const uint8_t*& ip, const uint8_t* end, const char* what) {
  switch (mode) {
    case 0:
      fse_build(T, def, defsym, deflog);
      break;
    case 1:
      if (ip >= end) fail(std::string(what) + ": truncated RLE table");
      if (*ip > maxsym) fail(std::string(what) + ": RLE symbol out of range");
      fse_single(T, *ip++);
      break;
    case 2:
      ip += fse_read(T, maxsym, maxlog, ip, size_t(end - ip), what);
      break;
    default:
      if (!have) fail(std::string(what) + ": repeat mode with no previous table");
      break;
  }
  have = true;
}

// A compressed block's content appended to out (already sized to hold
// `limit` bytes past `op`); returns the new end of output.
size_t compressed_block(FrameState& F, const uint8_t* ip, const uint8_t* end, Output& out,
                        size_t frame_start, size_t op, size_t limit) {
  // ---- literals section
  if (ip >= end) fail("compressed block: empty");
  const int ltype = ip[0] & 3, sf = (ip[0] >> 2) & 3;
  const uint8_t* lits;
  size_t nlits;
  if (ltype <= 1) {  // raw or RLE
    size_t hsize;
    if (sf == 0 || sf == 2) {
      hsize = 1;
      nlits = ip[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      if (end - ip < 2) fail("literals header: truncated");
      nlits = (ip[0] >> 4) + (size_t(ip[1]) << 4);
    } else {
      hsize = 3;
      if (end - ip < 3) fail("literals header: truncated");
      nlits = (ip[0] >> 4) + (size_t(ip[1]) << 4) + (size_t(ip[2]) << 12);
    }
    if (nlits > limit) fail("literals section: more literals than the block may hold");
    ip += hsize;
    if (ltype == 0) {
      if (size_t(end - ip) < nlits) fail("raw literals: truncated");
      lits = ip;
      ip += nlits;
    } else {
      if (ip >= end) fail("RLE literals: truncated");
      F.literals.assign(nlits, *ip++);
      lits = F.literals.data();
    }
  } else {  // Huffman-coded, with a tree (2) or the previous one (3)
    size_t hsize, regen, csize;
    int streams = sf == 0 ? 1 : 4;
    const int bits = sf <= 1 ? 10 : (sf == 2 ? 14 : 18);
    hsize = sf <= 1 ? 3 : (sf == 2 ? 4 : 5);
    if (size_t(end - ip) < hsize) fail("literals header: truncated");
    const uint64_t h = load_le(ip, hsize);
    regen = size_t((h >> 4) & ((uint64_t(1) << bits) - 1));
    csize = size_t((h >> (4 + bits)) & ((uint64_t(1) << bits) - 1));
    ip += hsize;
    if (regen > limit) fail("literals section: more literals than the block may hold");
    if (size_t(end - ip) < csize) fail("Huffman literals: truncated");
    const uint8_t* lend = ip + csize;
    if (ltype == 2) {
      ip += huffman_read(F.huffman, ip, csize);
      F.have_huffman = true;
    } else if (!F.have_huffman) {
      fail("treeless literals with no previous Huffman tree");
    }
    F.literals.resize(regen);
    uint8_t* dst = F.literals.data();
    if (streams == 1) {
      const size_t n1 = size_t(lend - ip);
      huffman_lanes<1>(F.huffman, &ip, &n1, &dst, &regen);
    } else {
      if (lend - ip < 6) fail("Huffman literals: truncated jump table");
      const size_t s1 = load_le(ip, 2), s2 = load_le(ip + 2, 2), s3 = load_le(ip + 4, 2);
      ip += 6;
      const size_t total = size_t(lend - ip);
      if (s1 + s2 + s3 > total) fail("Huffman literals: jump table past the section");
      const size_t s4 = total - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("Huffman literals: too few literals for four streams");
      const uint8_t* srcs[4] = {ip, ip + s1, ip + s1 + s2, ip + s1 + s2 + s3};
      const size_t sizes[4] = {s1, s2, s3, s4};
      uint8_t* outs[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
      const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huffman_lanes<4>(F.huffman, srcs, sizes, outs, counts);
    }
    ip = lend;
    lits = dst;
    nlits = regen;
  }

  // ---- sequences section
  if (ip >= end) fail("sequences section: missing");
  size_t nseq = ip[0];
  if (nseq < 128) {
    ip += 1;
  } else if (nseq < 255) {
    if (end - ip < 2) fail("sequences header: truncated");
    nseq = ((nseq - 128) << 8) + ip[1];
    ip += 2;
  } else {
    if (end - ip < 3) fail("sequences header: truncated");
    nseq = ip[1] + (size_t(ip[2]) << 8) + 0x7F00;
    ip += 3;
  }
  uint8_t* o = out.data;
  const size_t oend = op + limit;
  if (nseq == 0) {
    if (ip != end) fail("compressed block: bytes after a literals-only block");
    std::memcpy(o + op, lits, nlits);
    return op + nlits;
  }
  if (ip >= end) fail("sequences header: truncated");
  const int modes = *ip++;
  if (modes & 3) fail("sequences header: reserved bits set");
  sequence_table(modes >> 6, F.ll, F.have_ll, LL_DEFAULT, 36, 6, 35, 9, ip, end, "literal lengths table");
  sequence_table((modes >> 4) & 3, F.of, F.have_of, OF_DEFAULT, 29, 5, 31, 8, ip, end, "offsets table");
  sequence_table((modes >> 2) & 3, F.ml, F.have_ml, ML_DEFAULT, 53, 6, 52, 9, ip, end, "match lengths table");
  BackBits b;
  b.init(ip, size_t(end - ip), "sequences bitstream");
  uint32_t sll = uint32_t(b.read(F.ll.log)), sof = uint32_t(b.read(F.of.log)), sml = uint32_t(b.read(F.ml.log));
  size_t lit_at = 0;
  uint64_t* rep = F.rep;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry el = F.ll.t[sll], eo = F.of.t[sof], em = F.ml.t[sml];
    const int ofc = eo.symbol;
    const uint64_t ov = (uint64_t(1) << ofc) + b.read(ofc);
    const size_t ml = ML_BASE[em.symbol] + size_t(b.read(ML_BITS[em.symbol]));
    const size_t ll = LL_BASE[el.symbol] + size_t(b.read(LL_BITS[el.symbol]));
    uint64_t offset;
    if (ov > 3) {
      offset = ov - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const int idx = int(ov - 1) + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = el.base + uint32_t(b.read(el.nbits));
      sml = em.base + uint32_t(b.read(em.nbits));
      sof = eo.base + uint32_t(b.read(eo.nbits));
    }
    if (ll > nlits - lit_at) fail("sequence: more literals than the block holds");
    if (ll + ml > oend - op) fail("sequence: block output above its maximum size");
    std::memcpy(o + op, lits + lit_at, ll);
    op += ll;
    lit_at += ll;
    if (offset == 0 || offset > op - frame_start) fail("sequence: match offset before the frame's start");
    const uint8_t* from = o + op - offset;
    if (offset >= ml) {
      std::memcpy(o + op, from, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) o[op + k] = from[k];
    }
    op += ml;
  }
  if (b.left() != 0) fail("sequences bitstream: not consumed exactly");
  const size_t rest = nlits - lit_at;
  if (rest > oend - op) fail("compressed block: output above its maximum size");
  std::memcpy(o + op, lits + lit_at, rest);
  return op + rest;
}

// One frame (zstd or skippable) from src[at..n); returns the offset after it.
size_t frame(const uint8_t* src, size_t n, size_t at, Output& out) {
  if (n - at < 4) fail("truncated frame magic");
  const uint32_t magic = uint32_t(load_le(src + at, 4));
  at += 4;
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    if (n - at < 4) fail("skippable frame: truncated size");
    const uint64_t size = load_le(src + at, 4);
    at += 4;
    if (n - at < size) fail("skippable frame: truncated");
    return at + size_t(size);
  }
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic number)");
  if (n - at < 1) fail("truncated frame header");
  const uint8_t fhd = src[at++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 0x08) fail("frame header: reserved bit set");
  uint64_t window = 0;
  if (!single) {
    if (n - at < 1) fail("truncated frame header");
    const uint8_t wd = src[at++];
    const int wlog = 10 + (wd >> 3);
    const uint64_t base = uint64_t(1) << wlog;
    window = base + (base / 8) * (wd & 7);
  }
  const size_t did_size = did_flag == 3 ? 4 : size_t(did_flag);
  if (n - at < did_size) fail("truncated frame header");
  if (did_size && load_le(src + at, did_size) != 0) fail("frame needs a dictionary, which this decoder does not take");
  at += did_size;
  const size_t fcs_size = fcs_flag == 0 ? size_t(single) : (size_t(1) << fcs_flag);
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  if (n - at < fcs_size) fail("truncated frame header");
  if (fcs_size) fcs = load_le(src + at, fcs_size) + (fcs_size == 2 ? 256 : 0);
  at += fcs_size;
  if (single) window = fcs;
  const size_t block_max = size_t(std::min<uint64_t>(window, 128 * 1024));

  FrameState F;
  const size_t frame_start = out.size;
  if (has_fcs) out.reserve(frame_start + size_t(std::min<uint64_t>(fcs, uint64_t(64) << 20)));  // the rest grows as decoded
  for (;;) {
    if (n - at < 3) fail("truncated block header");
    const uint32_t bh = uint32_t(load_le(src + at, 3));
    at += 3;
    const bool last = bh & 1;
    const int btype = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    const size_t op = out.size;
    if (btype == 3) fail("block header: reserved block type");
    if (bsize > block_max) fail("block larger than the frame's maximum block size");
    if (btype == 1) {  // RLE: one byte, bsize times
      if (n - at < 1) fail("RLE block: truncated");
      out.reserve(op + bsize);
      std::memset(out.data + op, src[at], bsize);
      out.size = op + bsize;
      at += 1;
    } else {
      if (n - at < bsize) fail("block: truncated");
      if (btype == 0) {
        out.reserve(op + bsize);
        std::memcpy(out.data + op, src + at, bsize);
        out.size = op + bsize;
      } else {
        out.reserve(op + block_max);
        out.size = compressed_block(F, src + at, src + at + bsize, out, frame_start, op, block_max);
      }
      at += bsize;
    }
    if (last) break;
  }
  const size_t produced = out.size - frame_start;
  if (has_fcs && produced != fcs)
    fail("frame content size " + std::to_string(fcs) + " but " + std::to_string(produced) + " bytes decoded");
  if (checksum) {
    if (n - at < 4) fail("truncated content checksum");
    const uint32_t want = uint32_t(load_le(src + at, 4));
    at += 4;
    if (uint32_t(xxh64_impl(out.data + frame_start, produced, 0)) != want) fail("content checksum mismatch");
  }
  return at;
}

}  // namespace

extern "C" {

int zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len, char* err, size_t err_cap) {
  *out = nullptr;
  *out_len = 0;
  try {
    if (n == 0) fail("empty input: no zstd frame");
    Output buf;
    for (size_t at = 0; at < n;) at = frame(src, n, at, buf);
    buf.reserve(1);  // a buffer to hand over even when nothing was decoded
    *out_len = buf.size;
    *out = buf.release();
    return 0;
  } catch (const std::exception& e) {
    if (err_cap) {
      std::strncpy(err, e.what(), err_cap - 1);
      err[err_cap - 1] = 0;
    }
    return 1;
  }
}

void zstd_free(uint8_t* p) { std::free(p); }

uint32_t crc32c(const uint8_t* p, size_t n) { return crc32c_impl(p, n); }

}  // extern "C"
