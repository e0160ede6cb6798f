// Native wire codec of the PyTorch/CUDA port (nnstreamer_tpu_torch), a
// copy of the JAX package's native/nns_wire.cc.
//
// Implements the proto3 wire format of the reference's Tensors message
// (the reference's ext/nnstreamer/include/nnstreamer.proto — field
// numbers are the wire contract) as a C ABI loaded via ctypes
// (nativelib.py).  This is the host-side hot path of the edge layer (gRPC
// bridge, query offload): every cross-process tensor frame is
// encoded/decoded once, and the Python fallback (converters/codecs.py)
// parses varints byte-by-byte.
//
// Byte-exact with the Python codec: same field order on encode
// (num_tensor, fr, tensor..., format; per tensor: name?, type, packed
// 16-entry dims, data), same tolerance on decode (any field order,
// packed or unpacked dims, unknown fields skipped).

#include <cstdint>
#include <cstring>

namespace {

constexpr int kRankLimit = 16;
constexpr int kTensorLimit = 256;

inline size_t varint_size(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++n;
  }
  return n;
}

inline size_t write_varint(uint8_t* out, uint64_t v) {
  size_t n = 0;
  while (v >= 0x80) {
    out[n++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  out[n++] = static_cast<uint8_t>(v);
  return n;
}

// returns bytes consumed, 0 on truncation/overflow
inline size_t read_varint(const uint8_t* p, size_t len, uint64_t* v) {
  uint64_t acc = 0;
  for (size_t i = 0; i < len && i < 10; ++i) {
    acc |= static_cast<uint64_t>(p[i] & 0x7F) << (7 * i);
    if (!(p[i] & 0x80)) {
      *v = acc;
      return i + 1;
    }
  }
  return 0;
}

inline size_t tag_size(uint32_t field) {
  return varint_size(static_cast<uint64_t>(field) << 3);
}

inline size_t write_tag(uint8_t* out, uint32_t field, uint32_t wire) {
  return write_varint(out, (static_cast<uint64_t>(field) << 3) | wire);
}

size_t skip_field(const uint8_t* p, size_t len, uint32_t wire) {
  uint64_t v;
  size_t n;
  switch (wire) {
    case 0:
      return read_varint(p, len, &v);
    case 1:
      return len >= 8 ? 8 : 0;
    case 2:
      n = read_varint(p, len, &v);
      // subtractive form: n <= len here, and v can be near 2^64 from an
      // adversarial 10-byte varint — `n + v` would wrap
      if (!n || v > len - n) return 0;
      return n + static_cast<size_t>(v);
    case 5:
      return len >= 4 ? 4 : 0;
    default:
      return 0;  // unsupported wire type
  }
}

}  // namespace

extern "C" {

// Size bound for the encoded frame (exact header accounting).
uint64_t nns_pb_encode_bound(const uint64_t* payload_sizes,
                             const uint32_t* name_lens, uint32_t ntensors) {
  uint64_t total = 0;
  total += tag_size(1) + varint_size(ntensors);
  // fr submessage: 2 int32 varints (<= 5 bytes each as non-negative)
  total += tag_size(2) + 1 + 2 * (1 + 10);
  for (uint32_t i = 0; i < ntensors; ++i) {
    uint64_t t = 0;
    if (name_lens[i])
      t += tag_size(1) + varint_size(name_lens[i]) + name_lens[i];
    t += tag_size(2) + varint_size(32);                 // type
    t += tag_size(3) + varint_size(kRankLimit * 5) + kRankLimit * 5;
    t += tag_size(4) + varint_size(payload_sizes[i]) + payload_sizes[i];
    total += tag_size(3) + varint_size(t) + t;
  }
  total += tag_size(4) + varint_size(2);  // format
  return total;
}

// Encode one frame.  dims: ntensors x kRankLimit uint32 (innermost
// first, zero-padded).  Returns written length, or 0 on overflow.
uint64_t nns_pb_encode(const uint8_t* const* payloads,
                       const uint64_t* payload_sizes,
                       const uint32_t* dtypes,
                       const uint32_t* dims,
                       const uint8_t* const* names,
                       const uint32_t* name_lens, uint32_t ntensors,
                       int32_t rate_n, int32_t rate_d, uint32_t fmt,
                       uint8_t* out, uint64_t out_cap) {
  uint8_t* p = out;
  uint8_t* end = out + out_cap;
  if (ntensors > kTensorLimit) return 0;
#define NEED(n)                                    \
  do {                                             \
    if (static_cast<uint64_t>(end - p) < (n)) return 0; \
  } while (0)
  NEED(tag_size(1) + 10);
  p += write_tag(p, 1, 0);
  p += write_varint(p, ntensors);
  // fr { rate_n, rate_d } — proto3 int32 encodes negatives as 10-byte
  uint8_t frbuf[24];
  size_t frn = 0;
  frn += write_tag(frbuf + frn, 1, 0);
  frn += write_varint(frbuf + frn, static_cast<uint64_t>(
                                       static_cast<int64_t>(rate_n)));
  frn += write_tag(frbuf + frn, 2, 0);
  frn += write_varint(frbuf + frn, static_cast<uint64_t>(
                                       static_cast<int64_t>(rate_d)));
  NEED(tag_size(2) + varint_size(frn) + frn);
  p += write_tag(p, 2, 2);
  p += write_varint(p, frn);
  std::memcpy(p, frbuf, frn);
  p += frn;
  for (uint32_t i = 0; i < ntensors; ++i) {
    // dims: packed varints, always kRankLimit entries (reference
    // readers consume all 16)
    uint8_t dimbuf[kRankLimit * 5];
    size_t dn = 0;
    for (int d = 0; d < kRankLimit; ++d)
      dn += write_varint(dimbuf + dn, dims[i * kRankLimit + d]);
    uint64_t t = 0;
    if (name_lens[i])
      t += tag_size(1) + varint_size(name_lens[i]) + name_lens[i];
    t += tag_size(2) + varint_size(dtypes[i]);
    t += tag_size(3) + varint_size(dn) + dn;
    t += tag_size(4) + varint_size(payload_sizes[i]) + payload_sizes[i];
    NEED(tag_size(3) + varint_size(t) + t);
    p += write_tag(p, 3, 2);
    p += write_varint(p, t);
    if (name_lens[i]) {
      p += write_tag(p, 1, 2);
      p += write_varint(p, name_lens[i]);
      std::memcpy(p, names[i], name_lens[i]);
      p += name_lens[i];
    }
    p += write_tag(p, 2, 0);
    p += write_varint(p, dtypes[i]);
    p += write_tag(p, 3, 2);
    p += write_varint(p, dn);
    std::memcpy(p, dimbuf, dn);
    p += dn;
    p += write_tag(p, 4, 2);
    p += write_varint(p, payload_sizes[i]);
    std::memcpy(p, payloads[i], payload_sizes[i]);
    p += payload_sizes[i];
  }
  if (fmt) {
    NEED(tag_size(4) + varint_size(fmt));
    p += write_tag(p, 4, 0);
    p += write_varint(p, fmt);
  }
#undef NEED
  return static_cast<uint64_t>(p - out);
}

// Decode one frame in place: fills per-tensor views into `data`.
// Returns the number of tensors, or -1 on malformed input.
int32_t nns_pb_decode(const uint8_t* data, uint64_t len,
                      uint32_t max_tensors,
                      uint64_t* payload_offs, uint64_t* payload_lens,
                      uint32_t* dtypes, uint32_t* dims /*16 per tensor*/,
                      uint64_t* name_offs, uint64_t* name_lens,
                      int32_t* rate, uint32_t* fmt) {
  uint64_t i = 0;
  uint32_t count = 0;
  rate[0] = rate[1] = 0;
  *fmt = 0;
  while (i < len) {
    uint64_t key;
    size_t n = read_varint(data + i, len - i, &key);
    if (!n) return -1;
    i += n;
    uint32_t field = static_cast<uint32_t>(key >> 3);
    uint32_t wire = static_cast<uint32_t>(key & 7);
    if (field == 2 && wire == 2) {  // fr submessage
      uint64_t sub;
      n = read_varint(data + i, len - i, &sub);
      // all length checks below are subtractive (sub > remaining) so an
      // adversarial near-2^64 length can't wrap the addition
      if (!n || sub > len - i - n) return -1;
      i += n;
      uint64_t j = i, subend = i + sub;
      while (j < subend) {
        uint64_t k2;
        n = read_varint(data + j, subend - j, &k2);
        if (!n) return -1;
        j += n;
        if ((k2 >> 3) >= 1 && (k2 >> 3) <= 2 && (k2 & 7) == 0) {
          uint64_t v;
          n = read_varint(data + j, subend - j, &v);
          if (!n) return -1;
          j += n;
          rate[(k2 >> 3) - 1] = static_cast<int32_t>(v);
        } else {
          n = skip_field(data + j, subend - j, k2 & 7);
          if (!n) return -1;
          j += n;
        }
      }
      i = subend;
    } else if (field == 3 && wire == 2) {  // one Tensor
      uint64_t sub;
      n = read_varint(data + i, len - i, &sub);
      if (!n || sub > len - i - n) return -1;
      i += n;
      if (count >= max_tensors) return -1;
      uint64_t j = i, subend = i + sub;
      payload_offs[count] = payload_lens[count] = 0;
      name_offs[count] = name_lens[count] = 0;
      dtypes[count] = 11;  // NNS_END default
      int rank = 0;
      for (int d = 0; d < kRankLimit; ++d)
        dims[count * kRankLimit + d] = 0;
      while (j < subend) {
        uint64_t k2;
        n = read_varint(data + j, subend - j, &k2);
        if (!n) return -1;
        j += n;
        uint32_t f2 = static_cast<uint32_t>(k2 >> 3);
        uint32_t w2 = static_cast<uint32_t>(k2 & 7);
        uint64_t v;
        if (f2 == 1 && w2 == 2) {  // name
          n = read_varint(data + j, subend - j, &v);
          if (!n || v > subend - j - n) return -1;
          name_offs[count] = j + n;
          name_lens[count] = v;
          j += n + v;
        } else if (f2 == 2 && w2 == 0) {  // type
          n = read_varint(data + j, subend - j, &v);
          if (!n) return -1;
          dtypes[count] = static_cast<uint32_t>(v);
          j += n;
        } else if (f2 == 3 && w2 == 2) {  // packed dims
          n = read_varint(data + j, subend - j, &v);
          if (!n || v > subend - j - n) return -1;
          uint64_t dend = j + n + v;
          j += n;
          while (j < dend) {
            n = read_varint(data + j, dend - j, &v);
            if (!n) return -1;
            j += n;
            if (rank < kRankLimit)
              dims[count * kRankLimit + rank++] = static_cast<uint32_t>(v);
          }
        } else if (f2 == 3 && w2 == 0) {  // unpacked dim
          n = read_varint(data + j, subend - j, &v);
          if (!n) return -1;
          j += n;
          if (rank < kRankLimit)
            dims[count * kRankLimit + rank++] = static_cast<uint32_t>(v);
        } else if (f2 == 4 && w2 == 2) {  // payload
          n = read_varint(data + j, subend - j, &v);
          if (!n || v > subend - j - n) return -1;
          payload_offs[count] = j + n;
          payload_lens[count] = v;
          j += n + v;
        } else {
          n = skip_field(data + j, subend - j, w2);
          if (!n) return -1;
          j += n;
        }
      }
      i = subend;
      ++count;
    } else if (field == 4 && wire == 0) {  // format
      uint64_t v;
      n = read_varint(data + i, len - i, &v);
      if (!n) return -1;
      i += n;
      *fmt = static_cast<uint32_t>(v);
    } else if (field == 1 && wire == 0) {  // num_tensor (len(tensor) wins)
      uint64_t v;
      n = read_varint(data + i, len - i, &v);
      if (!n) return -1;
      i += n;
    } else {
      n = skip_field(data + i, len - i, wire);
      if (!n) return -1;
      i += n;
    }
  }
  return static_cast<int32_t>(count);
}

}  // extern "C"
