// Blosc1 frame decoder of the PyTorch/CUDA port (nnstreamer_tpu_torch),
// written from the c-blosc 1.x format description.
//
// Zarr arrays (v2 `"compressor": {"id": "blosc"}`, v3 codec `blosc`)
// store each chunk as one blosc frame.  The port reads orbax steps whose
// arrays carry such chunks without orbax, tensorstore or a blosc library
// (trainers/orbax_format.py); this file is the decoder it calls through
// ctypes (nativelib.py builds it with g++ on first use).
//
// A frame: a 16-byte header (format version 1 or 2, codec version,
// flags, type size, decoded size, block size, frame size; little
// endian), then either the decoded bytes themselves (flag 0x02, a
// "memcpyed" frame) or a table of block starts and the blocks.  A block
// is one stream, or `typesize` streams ("splits", one a byte of the
// element) unless flag 0x10 says it was not split; each stream is its
// compressed length (int32) and its bytes, stored raw where that length
// equals the stream's decoded size.  After decoding, a block is byte-
// unshuffled (flag 0x01) or bit-unshuffled (flag 0x04).
//
// Block codecs (flags >> 5): 0 blosclz (FastLZ level 2's format), 1 lz4
// and lz4hc (the lz4 block format), 2 snappy, decoded here; 3 zlib and 4
// zstd, decoded by the functions the caller passes (the port hands in
// Python's zlib module through a ctypes callback and nns_zstd.cc's
// decoder).
//
// Every read of the input and every write of the output is checked
// against its bounds: a corrupt or truncated frame returns a negative
// status, never reads or writes outside the buffers it was given.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Status : int32_t {
  kOk = 0,
  kCorrupt = -1,      // malformed header, block table or stream
  kTruncated = -2,    // the input ends inside the frame
  kDstTooSmall = -3,  // the output does not fit the caller's buffer
  kUnsupported = -4,  // a format version or block codec not read
  kCodec = -5,        // the zlib or zstd decoder refused a stream
  kNoCodec = -6,      // a zlib or zstd stream and no decoder given
  kNoMemory = -7,
};

// a decoder of one whole stream: (src, n, dst, cap, *decoded) -> status
typedef int32_t (*StreamFn)(const uint8_t*, uint64_t, uint8_t*, uint64_t,
                            uint64_t*);

struct Fail {
  int32_t code;
};

[[noreturn]] inline void fail(int32_t code) { throw Fail{code}; }

inline void need(bool ok, int32_t code = kCorrupt) {
  if (!ok) fail(code);
}

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86-64, aarch64)
}

constexpr uint32_t kHeader = 16;
constexpr uint32_t kMaxSplits = 16;
constexpr uint32_t kMinBuffer = 128;

// A match copy that may overlap its source (LZ77 run semantics).
inline void copy_match(uint8_t* op, size_t dist, size_t len) {
  const uint8_t* ref = op - dist;
  if (dist >= len) {
    std::memcpy(op, ref, len);
  } else {
    for (size_t i = 0; i < len; ++i) op[i] = ref[i];
  }
}

// -- blosclz ------------------------------------------------------------------

// FastLZ level 2's format: a literal run (ctrl < 32: ctrl + 1 bytes) or a
// match (length from ctrl's top 3 bits, 7 extended by 255-continued
// bytes; distance 13 bits, or 16 more after an escape).
size_t blosclz(const uint8_t* ip, size_t n, uint8_t* out, size_t cap) {
  constexpr size_t kMaxDistance = 8191;
  if (n == 0) return 0;
  const uint8_t* end = ip + n;
  uint8_t* op = out;
  uint8_t* op_end = out + cap;
  uint32_t ctrl = *ip++ & 31u;
  while (true) {
    if (ctrl >= 32) {
      size_t len = (ctrl >> 5) - 1;
      size_t ofs = static_cast<size_t>(ctrl & 31u) << 8;
      uint32_t code;
      if (len == 7 - 1) {
        do {
          need(ip < end, kTruncated);
          code = *ip++;
          len += code;
        } while (code == 255);
      }
      need(ip < end, kTruncated);
      code = *ip++;
      len += 3;
      size_t dist = ofs + code + 1;
      if (code == 255 && ofs == (31u << 8)) {
        need(end - ip >= 2, kTruncated);
        ofs = static_cast<size_t>(ip[0]) << 8 | ip[1];
        ip += 2;
        dist = ofs + kMaxDistance + 1;
      }
      need(static_cast<size_t>(op_end - op) >= len, kDstTooSmall);
      need(static_cast<size_t>(op - out) >= dist);
      copy_match(op, dist, len);
      op += len;
    } else {
      size_t len = ctrl + 1;
      need(static_cast<size_t>(op_end - op) >= len, kDstTooSmall);
      need(static_cast<size_t>(end - ip) >= len, kTruncated);
      std::memcpy(op, ip, len);
      op += len;
      ip += len;
    }
    if (ip >= end) break;
    ctrl = *ip++;
  }
  return static_cast<size_t>(op - out);
}

// -- lz4 (block format) -------------------------------------------------------

size_t lz4(const uint8_t* ip, size_t n, uint8_t* out, size_t cap) {
  const uint8_t* end = ip + n;
  uint8_t* op = out;
  uint8_t* op_end = out + cap;
  auto length = [&](size_t len) {
    if (len == 15) {
      uint32_t b;
      do {
        need(ip < end, kTruncated);
        b = *ip++;
        len += b;
      } while (b == 255);
    }
    return len;
  };
  need(n > 0, kTruncated);
  while (true) {
    need(ip < end, kTruncated);
    uint32_t token = *ip++;
    size_t lit = length(token >> 4);
    need(static_cast<size_t>(end - ip) >= lit, kTruncated);
    need(static_cast<size_t>(op_end - op) >= lit, kDstTooSmall);
    std::memcpy(op, ip, lit);
    op += lit;
    ip += lit;
    if (ip == end) break;  // the last sequence holds only literals
    need(end - ip >= 2, kTruncated);
    size_t dist = ip[0] | static_cast<size_t>(ip[1]) << 8;
    ip += 2;
    need(dist > 0 && dist <= static_cast<size_t>(op - out));
    size_t len = length(token & 15u) + 4;
    need(static_cast<size_t>(op_end - op) >= len, kDstTooSmall);
    copy_match(op, dist, len);
    op += len;
  }
  return static_cast<size_t>(op - out);
}

// -- snappy -------------------------------------------------------------------

size_t snappy(const uint8_t* ip, size_t n, uint8_t* out, size_t cap) {
  const uint8_t* end = ip + n;
  uint64_t want = 0;
  for (int shift = 0;; shift += 7) {
    need(ip < end, kTruncated);
    need(shift <= 28);
    uint32_t b = *ip++;
    want |= static_cast<uint64_t>(b & 0x7Fu) << shift;
    if (!(b & 0x80u)) break;
  }
  need(want <= cap, kDstTooSmall);
  uint8_t* op = out;
  uint8_t* op_end = out + want;
  while (ip < end) {
    uint32_t tag = *ip++;
    size_t len, dist;
    switch (tag & 3u) {
      case 0: {
        len = (tag >> 2) + 1;
        if (len > 60) {
          size_t extra = len - 60;
          need(static_cast<size_t>(end - ip) >= extra, kTruncated);
          len = 0;
          for (size_t i = 0; i < extra; ++i) len |= static_cast<size_t>(ip[i]) << (8 * i);
          len += 1;
          ip += extra;
        }
        need(static_cast<size_t>(end - ip) >= len, kTruncated);
        need(static_cast<size_t>(op_end - op) >= len, kDstTooSmall);
        std::memcpy(op, ip, len);
        op += len;
        ip += len;
        continue;
      }
      case 1:
        need(ip < end, kTruncated);
        len = 4 + ((tag >> 2) & 7u);
        dist = static_cast<size_t>(tag >> 5) << 8 | *ip++;
        break;
      case 2:
        need(end - ip >= 2, kTruncated);
        len = (tag >> 2) + 1;
        dist = ip[0] | static_cast<size_t>(ip[1]) << 8;
        ip += 2;
        break;
      default:
        need(end - ip >= 4, kTruncated);
        len = (tag >> 2) + 1;
        dist = rd32(ip);
        ip += 4;
        break;
    }
    need(dist > 0 && dist <= static_cast<size_t>(op - out));
    need(static_cast<size_t>(op_end - op) >= len, kDstTooSmall);
    copy_match(op, dist, len);
    op += len;
  }
  need(op == op_end);
  return want;
}

// -- unshuffling --------------------------------------------------------------

// Byte unshuffle of one block: src holds byte j of every element, then
// byte j + 1; the bytes past the last whole element stay in place.
void unshuffle(uint32_t ts, size_t size, const uint8_t* src, uint8_t* dst) {
  size_t ne = size / ts;
  for (size_t j = 0; j < ts; ++j) {
    const uint8_t* s = src + j * ne;
    for (size_t i = 0; i < ne; ++i) dst[i * ts + j] = s[i];
  }
  std::memcpy(dst + ne * ts, src + ne * ts, size - ne * ts);
}

// Bit unshuffle (bitshuffle's layout): for byte j of the element and bit
// k of that byte, one row of ne bits, bit (i % 8) of byte i / 8 being
// bit k of byte j of element i.  Format versions 1 and 2 shuffle only a
// block whose element count is a multiple of 8, and copy the others.
void bitunshuffle(uint32_t ts, size_t size, const uint8_t* src, uint8_t* dst) {
  size_t ne = size / ts;
  if (ne % 8) {
    std::memcpy(dst, src, size);
    return;
  }
  size_t row = ne / 8;  // bytes a bit row
  std::memset(dst, 0, ne * ts);
  for (size_t j = 0; j < ts; ++j) {
    for (int k = 0; k < 8; ++k) {
      const uint8_t* r = src + (j * 8 + k) * row;
      for (size_t b = 0; b < row; ++b) {
        uint32_t bits = r[b];
        if (!bits) continue;
        uint8_t* e = dst + (b * 8) * ts + j;
        for (int m = 0; m < 8; ++m)
          e[m * ts] |= static_cast<uint8_t>(((bits >> m) & 1u) << k);
      }
    }
  }
  std::memcpy(dst + ne * ts, src + ne * ts, size - ne * ts);
}

// -- the frame ----------------------------------------------------------------

struct Header {
  uint32_t version, flags, typesize, nbytes, blocksize, ctbytes;
};

Header header(const uint8_t* src, size_t n) {
  need(n >= kHeader, kTruncated);
  Header h{src[0], src[2], src[3], rd32(src + 4), rd32(src + 8), rd32(src + 12)};
  need(h.version == 1 || h.version == 2, kUnsupported);
  need(h.flags & 0x02 || (h.flags >> 5) <= 4, kUnsupported);
  need(h.typesize >= 1);
  need(h.ctbytes >= kHeader && h.ctbytes <= n, kTruncated);
  need(h.ctbytes == n);
  return h;
}

size_t stream(uint32_t codec, const uint8_t* s, size_t n, uint8_t* out,
              size_t cap, StreamFn zstd, StreamFn zlib) {
  switch (codec) {
    case 0: return blosclz(s, n, out, cap);
    case 1: return lz4(s, n, out, cap);
    case 2: return snappy(s, n, out, cap);
    default: {
      StreamFn fn = codec == 3 ? zlib : zstd;
      need(fn != nullptr, kNoCodec);
      uint64_t got = 0;
      int32_t rc = fn(s, n, out, cap, &got);
      need(rc == 0, rc == -3 ? kDstTooSmall : kCodec);
      need(got <= cap);
      return static_cast<size_t>(got);
    }
  }
}

size_t decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                  StreamFn zstd, StreamFn zlib) {
  Header h = header(src, n);
  need(h.nbytes <= cap, kDstTooSmall);
  if (h.nbytes == 0) return 0;
  if (h.flags & 0x02) {  // memcpyed
    need(h.ctbytes - kHeader == h.nbytes);
    std::memcpy(dst, src + kHeader, h.nbytes);
    return h.nbytes;
  }
  need(h.blocksize >= 1);
  const uint32_t codec = h.flags >> 5;
  const size_t nblocks = (static_cast<size_t>(h.nbytes) + h.blocksize - 1) / h.blocksize;
  const size_t leftover = h.nbytes % h.blocksize;
  const size_t table = kHeader + 4 * nblocks;
  need(table <= h.ctbytes, kTruncated);
  const bool byte_shuffle = (h.flags & 0x01) && h.typesize > 1;
  const bool bit_shuffle = (h.flags & 0x04) && h.blocksize >= h.typesize;
  std::vector<uint8_t> tmp;
  if (byte_shuffle || bit_shuffle) tmp.resize(h.blocksize);
  for (size_t b = 0; b < nblocks; ++b) {
    const bool last = b == nblocks - 1 && leftover;
    const size_t bsize = last ? leftover : h.blocksize;
    uint8_t* out = dst + b * static_cast<size_t>(h.blocksize);
    uint8_t* into = tmp.empty() ? out : tmp.data();
    size_t start = rd32(src + kHeader + 4 * b);
    need(start >= table && start <= h.ctbytes);
    const uint8_t* s = src + start;
    const uint8_t* end = src + h.ctbytes;
    const bool split = !(h.flags & 0x10) && !last && h.typesize <= kMaxSplits &&
                       h.blocksize / h.typesize >= kMinBuffer;
    const size_t nsplits = split ? h.typesize : 1;
    const size_t neblock = bsize / nsplits;
    need(neblock * nsplits == bsize);
    for (size_t k = 0; k < nsplits; ++k) {
      need(end - s >= 4, kTruncated);
      int32_t cbytes;
      std::memcpy(&cbytes, s, 4);
      s += 4;
      need(cbytes >= 0 && static_cast<size_t>(end - s) >= static_cast<size_t>(cbytes),
           kTruncated);
      uint8_t* o = into + k * neblock;
      if (static_cast<size_t>(cbytes) == neblock) {
        std::memcpy(o, s, neblock);
      } else {
        need(stream(codec, s, cbytes, o, neblock, zstd, zlib) == neblock);
      }
      s += cbytes;
    }
    if (byte_shuffle) {
      unshuffle(h.typesize, bsize, into, out);
    } else if (bit_shuffle) {
      bitunshuffle(h.typesize, bsize, into, out);
    }
  }
  return h.nbytes;
}

}  // namespace

extern "C" {

// The decoded size a frame's header declares.  Returns 0, or a negative
// status.
int32_t nns_blosc_nbytes(const uint8_t* src, uint64_t n, uint64_t* nbytes) {
  if (n < kHeader) return kTruncated;
  *nbytes = rd32(src + 4);
  return kOk;
}

// Decode the blosc frame src[0, n) into dst[0, cap); the decoded size
// goes to *out_len.  `zstd` and `zlib` decode one whole stream of those
// codecs (either may be null where the frame holds none).  Returns 0, or
// a negative status (see Status).
int32_t nns_blosc_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                             uint64_t cap, uint64_t* out_len, StreamFn zstd,
                             StreamFn zlib) {
  try {
    *out_len = decompress(src, static_cast<size_t>(n), dst,
                          static_cast<size_t>(cap), zstd, zlib);
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kCorrupt;
  }
}

}  // extern "C"
