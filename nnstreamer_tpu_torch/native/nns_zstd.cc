// Zstandard decoder of the PyTorch/CUDA port (nnstreamer_tpu_torch),
// written from RFC 8878, and the CRC-32C of the OCDBT format.
//
// The JAX package saves training steps with orbax, which stores every
// array as zarr chunks compressed with zstd inside an OCDBT key-value
// store whose nodes are zstd frames too.  The port reads those steps
// without orbax, tensorstore or a zstd library (trainers/ocdbt.py,
// trainers/orbax_format.py); this file is the decoder they call through
// ctypes (nativelib.py builds it with g++ on first use).
//
// Covered: frame headers (window descriptor, single segment, frame
// content size, checksum flag; a dictionary ID other than 0 is refused),
// skippable frames and concatenated frames; raw, RLE and compressed
// blocks; literals sections raw, RLE, Huffman-coded (one or four
// streams, the tree described directly or by FSE-coded weights) and
// treeless (the previous block's table); sequences with predefined, RLE,
// FSE-coded and repeated tables, the three repeat offsets and matches
// reaching back across blocks; the xxh64 content checksum.
//
// Every read of the input and every write of the output is checked
// against its bounds: corrupt or truncated input returns a negative
// error code, never reads or writes outside the buffers it was given.

#include <cstdint>
#include <cstring>
#include <new>

namespace {

enum Status : int32_t {
  kOk = 0,
  kCorrupt = -1,      // malformed frame, block, table or stream
  kTruncated = -2,    // the input ends inside a frame
  kDstTooSmall = -3,  // the output does not fit the caller's buffer
  kUnsupported = -4,  // a dictionary, a reserved field set
  kChecksum = -5,     // the content checksum does not match
  kSizeMismatch = -6, // the frame content size does not match
  kNoMemory = -7,
};

struct Fail {
  int32_t code;
};

[[noreturn]] inline void fail(int32_t code) { throw Fail{code}; }

inline void need(bool ok, int32_t code = kCorrupt) {
  if (!ok) fail(code);
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (static_cast<uint32_t>(p[2]) << 16);
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86-64, aarch64)
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// -- xxh64 --------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -- crc32c (Castagnoli, reflected 0x82F63B78) -------------------------------

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable kCrc;

uint32_t crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo = rd32(p) ^ c, hi = rd32(p + 4);
    c = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
        kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
        kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
        kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ kCrc.t[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// -- bit readers --------------------------------------------------------------

// Forward little-endian bits: the FSE table descriptions.  Bits past the
// end read as zeros; the caller checks how many bytes it consumed.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++pos) {
      size_t byte = pos >> 3;
      if (byte < n) v |= static_cast<uint32_t>((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t peek(int nb) {
    size_t save = pos;
    uint32_t v = read(nb);
    pos = save;
    return v;
  }
};

// Backward bits (Huffman streams, FSE streams): read from the end of
// the stream towards its start, the first bit being below the highest
// set bit of the last byte.  `container` holds the 8 bytes at `ptr`;
// `consumed` counts its bits already read, from the top.  Bits before
// the start of the stream read as zeros and set `consumed` above 64,
// which overflowed() reports.
struct BackBits {
  const uint8_t* start;
  const uint8_t* ptr;
  uint64_t container;
  unsigned consumed;

  void init(const uint8_t* src, size_t n) {
    need(n >= 1);
    start = src;
    uint8_t last = src[n - 1];
    need(last != 0);  // the end mark must be in the last byte
    if (n >= 8) {
      ptr = src + n - 8;
      container = rd64(ptr);
      consumed = 0;
    } else {
      ptr = src;
      container = 0;
      for (size_t i = 0; i < n; ++i) container |= static_cast<uint64_t>(src[i]) << (8 * i);
      consumed = static_cast<unsigned>(8 * (8 - n));
    }
    consumed += 8 - highbit32(last);
  }
  inline uint64_t peek(unsigned nb) const {
    if (consumed >= 64 || nb == 0) return 0;
    return ((container << consumed) >> 1) >> (63 - nb);
  }
  inline void skip(unsigned nb) { consumed += nb; }
  inline uint64_t read(unsigned nb) {
    uint64_t v = peek(nb);
    consumed += nb;
    return v;
  }
  inline void reload() {
    if (consumed > 64) return;  // overflowed: stays so
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      container = rd64(ptr);
      return;
    }
    if (ptr == start) return;  // (a stream under 8 bytes stays here)
    size_t back = consumed >> 3;
    if (back > static_cast<size_t>(ptr - start)) back = static_cast<size_t>(ptr - start);
    ptr -= back;
    consumed -= static_cast<unsigned>(back * 8);
    container = rd64(ptr);
  }
  bool overflowed() const { return consumed > 64; }
  bool finished() const { return ptr == start && consumed == 64; }
};

// -- FSE ----------------------------------------------------------------------

struct FseEntry {
  uint16_t state_base;
  uint8_t symbol;
  uint8_t nbits;
};

constexpr int kMaxFseLog = 9;

struct FseTable {
  int log = -1;  // -1: no table yet (a repeat mode then is corrupt)
  FseEntry e[1 << kMaxFseLog];
};

// Read a normalized distribution; returns bytes consumed.
size_t read_ncount(const uint8_t* src, size_t n, int max_log, int max_sym,
                   int16_t* norm, int* nsym, int* log) {
  need(n >= 1, kTruncated);
  FwdBits br{src, n};
  int acc = static_cast<int>(br.read(4)) + 5;
  need(acc <= max_log);
  *log = acc;
  int remaining = (1 << acc) + 1;
  int threshold = 1 << acc;
  int nbits = acc + 1;
  int sym = 0;
  while (remaining > 1) {
    need(sym <= max_sym);
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1);
    if (static_cast<int>(low & (threshold - 1)) < max) {
      count = static_cast<int>(low & (threshold - 1));
      br.pos += nbits - 1;
    } else {
      count = static_cast<int>(br.peek(nbits) & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.pos += nbits;
    }
    count -= 1;  // -1: a "less than one" probability
    remaining -= count < 0 ? -count : count;
    need(remaining >= 1);
    norm[sym++] = static_cast<int16_t>(count);
    if (count == 0) {
      // zero-probability runs: 2-bit repeat flags, 3 means "more"
      for (;;) {
        uint32_t rep = br.read(2);
        for (uint32_t k = 0; k < rep; ++k) {
          need(sym <= max_sym);
          norm[sym++] = 0;
        }
        if (rep != 3) break;
        need((br.pos >> 3) <= n, kTruncated);
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
    need((br.pos >> 3) <= n + 4, kTruncated);
  }
  need(remaining == 1);
  size_t used = (br.pos + 7) >> 3;
  need(used <= n, kTruncated);
  *nsym = sym;
  return used;
}

void build_fse(FseTable* t, const int16_t* norm, int nsym, int log) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t->e[high--].symbol = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t->e[pos].symbol = static_cast<uint8_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  need(pos == 0);
  for (int u = 0; u < size; ++u) {
    int s = t->e[u].symbol;
    uint32_t x = next[s]++;
    int nb = log - highbit32(x);
    t->e[u].nbits = static_cast<uint8_t>(nb);
    t->e[u].state_base = static_cast<uint16_t>((x << nb) - size);
  }
  t->log = log;
}

void build_rle(FseTable* t, uint8_t sym) {
  t->e[0] = FseEntry{0, sym, 0};
  t->log = 0;
}

// -- Huffman ------------------------------------------------------------------

constexpr int kMaxHufBits = 11;

struct HufTable {
  int log = 0;  // 0: no table yet (treeless literals then are corrupt)
  uint16_t e[1 << kMaxHufBits];  // symbol | bits << 8
};

// Decode the FSE-compressed Huffman weights (two interleaved states).
int fse_weights(const uint8_t* src, size_t n, uint8_t* w) {
  int16_t norm[256];
  int nsym, log;
  size_t used = read_ncount(src, n, 6, 255, norm, &nsym, &log);
  FseTable t;
  build_fse(&t, norm, nsym, log);
  need(used < n);
  BackBits br;
  br.init(src + used, n - used);
  uint32_t s1 = static_cast<uint32_t>(br.read(log));
  uint32_t s2 = static_cast<uint32_t>(br.read(log));
  br.reload();
  need(!br.overflowed());
  int count = 0;
  for (;;) {
    need(count <= 253);
    const FseEntry& a = t.e[s1];
    w[count++] = a.symbol;
    s1 = a.state_base + static_cast<uint32_t>(br.read(a.nbits));
    br.reload();
    if (br.overflowed()) {
      w[count++] = t.e[s2].symbol;
      break;
    }
    need(count <= 253);
    const FseEntry& b = t.e[s2];
    w[count++] = b.symbol;
    s2 = b.state_base + static_cast<uint32_t>(br.read(b.nbits));
    br.reload();
    if (br.overflowed()) {
      w[count++] = t.e[s1].symbol;
      break;
    }
  }
  return count;
}

// Read a Huffman tree description; returns bytes consumed.
size_t read_huf(const uint8_t* src, size_t n, HufTable* h) {
  need(n >= 1, kTruncated);
  uint8_t w[256];
  int nw;
  size_t used;
  uint8_t hb = src[0];
  if (hb < 128) {
    need(hb >= 1 && static_cast<size_t>(hb) + 1 <= n, kTruncated);
    nw = fse_weights(src + 1, hb, w);
    used = 1 + static_cast<size_t>(hb);
  } else {
    nw = hb - 127;
    size_t bytes = (static_cast<size_t>(nw) + 1) / 2;
    need(1 + bytes <= n, kTruncated);
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  }
  need(nw >= 1 && nw <= 255);
  uint32_t total = 0;
  int rank1 = 0;
  for (int i = 0; i < nw; ++i) {
    need(w[i] <= kMaxHufBits);
    if (w[i]) total += 1u << (w[i] - 1);
    rank1 += w[i] == 1;
  }
  need(total > 0);
  int log = highbit32(total) + 1;
  need(log <= kMaxHufBits);
  uint32_t rest = (1u << log) - total;
  need((rest & (rest - 1)) == 0);  // a power of two (nonzero: log is above)
  int last = highbit32(rest) + 1;
  w[nw] = static_cast<uint8_t>(last);
  rank1 += last == 1;
  need(rank1 >= 2 && (rank1 & 1) == 0);
  int nsym = nw + 1;
  uint32_t pos = 0;
  for (int wt = 1; wt <= log; ++wt) {
    for (int s = 0; s < nsym; ++s) {
      if (w[s] != wt) continue;
      uint32_t len = 1u << (wt - 1);
      uint8_t nb = static_cast<uint8_t>(log + 1 - wt);
      need(pos + len <= (1u << log));
      uint16_t v = static_cast<uint16_t>(s | (nb << 8));
      for (uint32_t k = 0; k < len; ++k) h->e[pos + k] = v;
      pos += len;
    }
  }
  need(pos == (1u << log));
  h->log = log;
  return used;
}

// Decode symbols [i, count) of one stream whose reader is set up.
void huf_tail(const HufTable& h, BackBits& br, uint8_t* out, size_t i,
              size_t count) {
  const unsigned log = static_cast<unsigned>(h.log);
  // four symbols a reload while the container holds 4 * log unread bits
  while (i + 4 <= count) {
    br.reload();
    if (br.consumed + 4 * log > 64) break;
    for (int k = 0; k < 4; ++k) {
      uint16_t v = h.e[(br.container << br.consumed) >> (64 - log)];
      out[i++] = static_cast<uint8_t>(v);
      br.skip(v >> 8);
    }
  }
  while (i < count) {
    br.reload();
    need(!br.overflowed());
    uint16_t v = h.e[br.peek(log)];
    out[i++] = static_cast<uint8_t>(v);
    br.skip(v >> 8);
  }
  br.reload();
  need(br.finished());
}

void huf_stream(const HufTable& h, const uint8_t* src, size_t n, uint8_t* out,
                size_t count) {
  BackBits br;
  br.init(src, n);
  huf_tail(h, br, out, 0, count);
}

// The four streams of a literals section, decoded side by side while
// each container holds four symbols, then each to its end.
void huf_4streams(const HufTable& h, const uint8_t* d, const size_t* sizes,
                  uint8_t* lit, size_t seg, size_t regen) {
  const unsigned log = static_cast<unsigned>(h.log);
  BackBits b[4];
  uint8_t* o[4];
  for (int s = 0; s < 4; ++s) {
    b[s].init(d, sizes[s]);
    d += sizes[s];
    o[s] = lit + s * seg;
  }
  const size_t last = regen - 3 * seg;  // the fourth stream's share (<= seg)
  size_t i = 0;
  while (i + 4 <= last) {
    bool room = true;
    for (int s = 0; s < 4; ++s) {
      b[s].reload();
      room &= b[s].consumed + 4 * log <= 64;
    }
    if (!room) break;
    for (int k = 0; k < 4; ++k) {
      for (int s = 0; s < 4; ++s) {
        uint16_t v = h.e[(b[s].container << b[s].consumed) >> (64 - log)];
        o[s][i + k] = static_cast<uint8_t>(v);
        b[s].skip(v >> 8);
      }
    }
    i += 4;
  }
  for (int s = 0; s < 4; ++s) huf_tail(h, b[s], o[s], i, s < 3 ? seg : last);
}

// -- sequences ----------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,    1,    2,     3,     4,     5,    6,    7,   8,
                              9,    10,   11,    12,    13,    14,   15,   16,  18,
                              20,   22,   24,    28,    32,    40,   48,   64,  128,
                              256,  512,  1024,  2048,  4096,  8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,  16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,  30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,  83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  FseTable ll, of, ml;
  HufTable huf;
  uint32_t rep[3] = {1, 4, 8};
};

// One table of the sequences section; returns bytes consumed.
size_t read_seq_table(int mode, const uint8_t* src, size_t n, FseTable* t,
                      const int16_t* def, int def_n, int def_log, int max_log,
                      int max_sym) {
  switch (mode) {
    case 0:
      build_fse(t, def, def_n, def_log);
      return 0;
    case 1:
      need(n >= 1, kTruncated);
      need(src[0] <= max_sym);
      build_rle(t, src[0]);
      return 1;
    case 2: {
      int16_t norm[256];
      int nsym, log;
      size_t used = read_ncount(src, n, max_log, max_sym, norm, &nsym, &log);
      build_fse(t, norm, nsym, log);
      return used;
    }
    default:
      need(t->log >= 0);  // repeat: the previous block's table
      return 0;
  }
}

// Decode one compressed block into out[*opos...cap); frame_start is
// where this frame's output starts (matches may not reach before it).
void compressed_block(FrameState& fs, const uint8_t* src, size_t n, uint8_t* out,
                      size_t frame_start, size_t* opos, size_t cap,
                      uint8_t* lit) {
  // literals section
  need(n >= 1, kTruncated);
  int ltype = src[0] & 3;
  int sfmt = (src[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  int streams = 1;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      need(n >= 2, kTruncated);
      hsize = 2;
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4);
    } else {
      need(n >= 3, kTruncated);
      hsize = 3;
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4) +
              (static_cast<size_t>(src[2]) << 12);
    }
  } else {
    if (sfmt < 2) {
      need(n >= 3, kTruncated);
      hsize = 3;
      uint32_t h = rd24(src);
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
      streams = sfmt == 0 ? 1 : 4;
    } else if (sfmt == 2) {
      need(n >= 4, kTruncated);
      hsize = 4;
      uint32_t h = rd32(src);
      regen = (h >> 4) & 0x3FFF;
      csize = (h >> 18) & 0x3FFF;
      streams = 4;
    } else {
      need(n >= 5, kTruncated);
      hsize = 5;
      uint64_t h = rd32(src) | (static_cast<uint64_t>(src[4]) << 32);
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
      streams = 4;
    }
  }
  need(regen <= (128u << 10));
  const uint8_t* p = src + hsize;
  size_t left = n - hsize;
  if (ltype == 0) {
    need(regen <= left, kTruncated);
    std::memcpy(lit, p, regen);
    p += regen;
    left -= regen;
  } else if (ltype == 1) {
    need(left >= 1, kTruncated);
    std::memset(lit, p[0], regen);
    p += 1;
    left -= 1;
  } else {
    need(csize <= left, kTruncated);
    const uint8_t* q = p;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = read_huf(q, qn, &fs.huf);
      q += used;
      qn -= used;
    } else {
      need(fs.huf.log > 0);  // treeless: the previous table
    }
    if (streams == 1) {
      huf_stream(fs.huf, q, qn, lit, regen);
    } else {
      need(qn >= 6, kTruncated);
      size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
      need(s1 + s2 + s3 + 6 <= qn, kTruncated);
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      need(3 * seg <= regen);
      const size_t sizes[4] = {s1, s2, s3, s4};
      huf_4streams(fs.huf, q + 6, sizes, lit, seg, regen);
    }
    p += csize;
    left -= csize;
  }

  // sequences section
  need(left >= 1, kTruncated);
  size_t nseq;
  uint8_t b0 = p[0];
  if (b0 == 0) {
    need(left == 1);
    nseq = 0;
    p += 1;
    left -= 1;
  } else if (b0 < 128) {
    nseq = b0;
    p += 1;
    left -= 1;
  } else if (b0 < 255) {
    need(left >= 2, kTruncated);
    nseq = (static_cast<size_t>(b0 - 128) << 8) + p[1];
    p += 2;
    left -= 2;
  } else {
    need(left >= 3, kTruncated);
    nseq = p[1] + (static_cast<size_t>(p[2]) << 8) + 0x7F00;
    p += 3;
    left -= 3;
  }
  size_t o = *opos;
  const uint8_t* lp = lit;
  const uint8_t* lend = lit + regen;
  if (nseq > 0) {
    need(left >= 1, kTruncated);
    uint8_t modes = p[0];
    need((modes & 3) == 0, kUnsupported);
    p += 1;
    left -= 1;
    size_t u;
    u = read_seq_table((modes >> 6) & 3, p, left, &fs.ll, kLLDefault, 36, 6, 9, 35);
    p += u;
    left -= u;
    u = read_seq_table((modes >> 4) & 3, p, left, &fs.of, kOFDefault, 29, 5, 8, 31);
    p += u;
    left -= u;
    u = read_seq_table((modes >> 2) & 3, p, left, &fs.ml, kMLDefault, 53, 6, 9, 52);
    p += u;
    left -= u;
    BackBits br;
    br.init(p, left);
    uint32_t sll = static_cast<uint32_t>(br.read(fs.ll.log));
    uint32_t sof = static_cast<uint32_t>(br.read(fs.of.log));
    uint32_t sml = static_cast<uint32_t>(br.read(fs.ml.log));
    for (size_t k = 0; k < nseq; ++k) {
      const FseEntry& el = fs.ll.e[sll];
      const FseEntry& eo = fs.of.e[sof];
      const FseEntry& em = fs.ml.e[sml];
      int ofc = eo.symbol, mlc = em.symbol, llc = el.symbol;
      need(mlc <= 52 && llc <= 35 && ofc <= 31);
      br.reload();
      uint64_t ofv = (1ULL << ofc) + br.read(ofc);
      br.reload();
      size_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      br.reload();
      size_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      if (k + 1 < nseq) {
        br.reload();
        sll = el.state_base + static_cast<uint32_t>(br.read(el.nbits));
        sml = em.state_base + static_cast<uint32_t>(br.read(em.nbits));
        br.reload();
        sof = eo.state_base + static_cast<uint32_t>(br.read(eo.nbits));
      }
      need(!br.overflowed());
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = static_cast<uint32_t>(off);
      } else {
        uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = fs.rep[0];
        } else {
          off = idx == 3 ? static_cast<uint64_t>(fs.rep[0]) - 1 : fs.rep[idx];
          need(off != 0);
          if (idx != 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = static_cast<uint32_t>(off);
        }
      }
      need(off <= 0xFFFFFFFFULL);
      // literals, then the match
      need(ll <= static_cast<size_t>(lend - lp));
      need(ll <= cap - o, kDstTooSmall);
      std::memcpy(out + o, lp, ll);
      lp += ll;
      o += ll;
      need(off <= o - frame_start);
      need(ml <= cap - o, kDstTooSmall);
      uint8_t* d = out + o;
      const uint8_t* s = d - off;
      if (off >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (size_t i = 0; i < ml; ++i) d[i] = s[i];
      }
      o += ml;
    }
    br.reload();
    need(br.finished());
  }
  size_t rest = static_cast<size_t>(lend - lp);
  need(rest <= cap - o, kDstTooSmall);
  std::memcpy(out + o, lp, rest);
  o += rest;
  need(o - *opos <= (128u << 10));
  *opos = o;
}

struct FrameHeader {
  size_t size;          // header bytes
  int64_t content;      // -1: not stored
  bool checksum;
  uint64_t window;
};

FrameHeader frame_header(const uint8_t* src, size_t n) {
  need(n >= 5, kTruncated);
  FrameHeader fh{};
  uint8_t d = src[4];
  int fcs_flag = d >> 6;
  bool single = (d >> 5) & 1;
  need(((d >> 3) & 1) == 0, kUnsupported);  // reserved bit
  fh.checksum = (d >> 2) & 1;
  int did_flag = d & 3;
  size_t pos = 5;
  if (!single) {
    need(n >= pos + 1, kTruncated);
    uint8_t wd = src[pos++];
    int exp = wd >> 3, mant = wd & 7;
    uint64_t base = 1ULL << (10 + exp);
    fh.window = base + (base / 8) * mant;
  }
  static const int kDidSize[4] = {0, 1, 2, 4};
  size_t dsz = kDidSize[did_flag];
  need(n >= pos + dsz, kTruncated);
  uint32_t did = 0;
  for (size_t i = 0; i < dsz; ++i) did |= static_cast<uint32_t>(src[pos + i]) << (8 * i);
  need(did == 0, kUnsupported);
  pos += dsz;
  static const int kFcsSize[4] = {0, 2, 4, 8};
  size_t fsz = kFcsSize[fcs_flag];
  if (fcs_flag == 0 && single) fsz = 1;
  need(n >= pos + fsz, kTruncated);
  if (fsz == 0) {
    fh.content = -1;
  } else {
    uint64_t v = 0;
    for (size_t i = 0; i < fsz; ++i) v |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
    if (fsz == 2) v += 256;
    need(v <= static_cast<uint64_t>(INT64_MAX));
    fh.content = static_cast<int64_t>(v);
  }
  pos += fsz;
  if (single) fh.window = static_cast<uint64_t>(fh.content);
  fh.size = pos;
  return fh;
}

inline bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }
constexpr uint32_t kMagic = 0xFD2FB528u;

// Decode every frame of src into dst; returns the bytes written.
size_t decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t ip = 0, o = 0;
  need(n >= 4, kTruncated);
  uint8_t* lit = new uint8_t[128u << 10];
  struct Del {
    uint8_t* p;
    ~Del() { delete[] p; }
  } del{lit};
  FrameState* fs = new FrameState();
  struct DelFs {
    FrameState* p;
    ~DelFs() { delete p; }
  } delfs{fs};
  while (ip < n) {
    need(n - ip >= 4, kTruncated);
    uint32_t magic = rd32(src + ip);
    if (skippable(magic)) {
      need(n - ip >= 8, kTruncated);
      uint64_t len = rd32(src + ip + 4);
      need(len <= n - ip - 8, kTruncated);
      ip += 8 + len;
      continue;
    }
    need(magic == kMagic);
    FrameHeader fh = frame_header(src + ip, n - ip);
    ip += fh.size;
    *fs = FrameState();
    size_t frame_start = o;
    uint64_t block_max = fh.window < (128u << 10) ? fh.window : (128u << 10);
    for (;;) {
      need(n - ip >= 3, kTruncated);
      uint32_t bh = rd24(src + ip);
      ip += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      need(type != 3);
      if (type == 1) {
        need(bsize <= block_max);
        need(n - ip >= 1, kTruncated);
        need(bsize <= cap - o, kDstTooSmall);
        std::memset(dst + o, src[ip], bsize);
        o += bsize;
        ip += 1;
      } else {
        need(bsize <= block_max);
        need(bsize <= n - ip, kTruncated);
        if (type == 0) {
          need(bsize <= cap - o, kDstTooSmall);
          std::memcpy(dst + o, src + ip, bsize);
          o += bsize;
        } else {
          compressed_block(*fs, src + ip, bsize, dst, frame_start, &o, cap, lit);
        }
        ip += bsize;
      }
      if (last) break;
    }
    if (fh.content >= 0) need(o - frame_start == static_cast<uint64_t>(fh.content), kSizeMismatch);
    if (fh.checksum) {
      need(n - ip >= 4, kTruncated);
      uint32_t want = rd32(src + ip);
      ip += 4;
      uint32_t got = static_cast<uint32_t>(xxh64(dst + frame_start, o - frame_start, 0));
      need(got == want, kChecksum);
    }
  }
  return o;
}

}  // namespace

extern "C" {

// Decode the zstd frames of src[0, n) into dst[0, cap); the decoded size
// goes to *out_len.  Returns 0, or a negative status (see Status).
int32_t nns_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                            uint64_t cap, uint64_t* out_len) {
  try {
    *out_len = decompress(src, static_cast<size_t>(n), dst, static_cast<size_t>(cap));
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kCorrupt;
  }
}

// The content size the first frame declares into *size (-1 when the
// frame does not store it).  Returns 0, or a negative status.
int32_t nns_zstd_content_size(const uint8_t* src, uint64_t n, int64_t* size) {
  try {
    need(n >= 4, kTruncated);
    need(rd32(src) == kMagic);
    *size = frame_header(src, static_cast<size_t>(n)).content;
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return kCorrupt;
  }
}

uint32_t nns_crc32c(const uint8_t* p, uint64_t n) {
  return crc32c(p, static_cast<size_t>(n));
}

}  // extern "C"
