// Native data-plane core for the offline preprocessing path (the port's
// copy of emernerf_tpu/native/wirecodec.cc; the code below the includes is
// the original's, held to it by tests/test_torch_native.py).
//
// A dependency-free host C++ core for the three hot wire-format primitives
// that TensorFlow's C++ kernels give the reference's preprocessor
// (datasets/waymo_preprocess.py:21-23), exposed to Python through ctypes
// (emernerf_torch/native/__init__.py):
//
//   en_crc32c         masked-CRC32C checksums (slice-by-8 Castagnoli)
//   en_tfrecord_index frame the records of a whole mapped TFRecord file
//   en_scan_fields    one-level protobuf field scan (tag walk) of a message
//   en_decode_varints decode a packed-varint payload
//
// Schema interpretation stays in Python (emernerf_torch/tools/waymo_wire.py).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC wirecodec.cc -o libwirecodec.so
// (driven by emernerf_torch/native/__init__.py at first use, into
// build/emernerf_torch/ at the repository root).

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------
// CRC32C (Castagnoli, reflected poly 0x82F63B78), slice-by-8.
// ---------------------------------------------------------------------
static uint32_t kCrcTable[8][256];
static bool kCrcInit = false;

static void crc_init() {
  for (int n = 0; n < 256; ++n) {
    uint32_t c = static_cast<uint32_t>(n);
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    kCrcTable[0][n] = c;
  }
  for (int n = 0; n < 256; ++n) {
    uint32_t c = kCrcTable[0][n];
    for (int t = 1; t < 8; ++t) {
      c = kCrcTable[0][c & 0xFF] ^ (c >> 8);
      kCrcTable[t][n] = c;
    }
  }
  kCrcInit = true;
}

uint32_t en_crc32c(const uint8_t* data, size_t n) {
  if (!kCrcInit) crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  // align-free slice-by-8 main loop
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = kCrcTable[7][lo & 0xFF] ^ kCrcTable[6][(lo >> 8) & 0xFF] ^
          kCrcTable[5][(lo >> 16) & 0xFF] ^ kCrcTable[4][lo >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = kCrcTable[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

static inline uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = en_crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

uint32_t en_masked_crc(const uint8_t* data, size_t n) {
  return masked_crc(data, n);
}

// ---------------------------------------------------------------------
// TFRecord framing: scan a whole in-memory file image, emitting
// (payload offset, payload length) per record.  Returns the record count,
// or a negative error code:
//   -1 truncated header/payload     -2 length-CRC mismatch
//   -3 data-CRC mismatch            -4 out array too small
// verify: 0 = trust CRCs, 1 = verify length CRCs, 2 = verify both.
// ---------------------------------------------------------------------
int64_t en_tfrecord_index(const uint8_t* buf, uint64_t n, uint64_t* offsets,
                          uint64_t* lengths, int64_t max_records,
                          int verify) {
  uint64_t i = 0;
  int64_t count = 0;
  while (i < n) {
    // All bounds checks are subtraction-style: a corrupt/crafted record
    // length near 2^64 must not wrap an addition and pass the check
    // (i <= n is a loop invariant, so n - i never underflows).
    if (n - i < 12) return -1;
    uint64_t len;
    std::memcpy(&len, buf + i, 8);  // little-endian host assumed (x86/ARM)
    uint32_t len_crc;
    std::memcpy(&len_crc, buf + i + 8, 4);
    if (verify >= 1 && masked_crc(buf + i, 8) != len_crc) return -2;
    uint64_t payload = i + 12;
    uint64_t avail = n - payload;  // bytes after the header
    if (avail < 4 || len > avail - 4) return -1;
    if (verify >= 2) {
      uint32_t data_crc;
      std::memcpy(&data_crc, buf + payload + len, 4);
      if (masked_crc(buf + payload, len) != data_crc) return -3;
    }
    if (count >= max_records) return -4;
    offsets[count] = payload;
    lengths[count] = len;
    ++count;
    i = payload + len + 4;
  }
  return count;
}

// ---------------------------------------------------------------------
// One-level protobuf wire scan.  For each top-level field of the message
// in buf[0..n) emit:
//   field_num[k]  field number
//   wire_type[k]  0 varint | 1 fixed64 | 2 length-delimited | 5 fixed32
//   off[k], len[k]  payload span within buf (for wire 2: the bytes after
//                   the length prefix; for 0: span of the varint bytes;
//                   for 1/5: the 8/4 fixed bytes)
//   value[k]      decoded varint for wire 0 (uint64), else 0
// Returns the field count, or negative on malformed input:
//   -1 truncated varint/payload     -5 unsupported wire type (3/4 groups)
//   -4 out arrays too small
// ---------------------------------------------------------------------
static inline bool read_varint(const uint8_t* buf, uint64_t n, uint64_t* i,
                               uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*i < n && shift < 64) {
    uint8_t b = buf[(*i)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

int64_t en_scan_fields(const uint8_t* buf, uint64_t n, uint32_t* field_num,
                       uint8_t* wire_type, uint64_t* off, uint64_t* len,
                       uint64_t* value, int64_t max_fields) {
  uint64_t i = 0;
  int64_t count = 0;
  while (i < n) {
    uint64_t tag;
    if (!read_varint(buf, n, &i, &tag)) return -1;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (count >= max_fields) return -4;
    uint64_t v = 0, o = i, l = 0;
    switch (wire) {
      case 0: {
        if (!read_varint(buf, n, &i, &v)) return -1;
        l = i - o;
        break;
      }
      case 1: {
        if (n - i < 8) return -1;
        l = 8;
        i += 8;
        break;
      }
      case 2: {
        uint64_t ln;
        if (!read_varint(buf, n, &i, &ln)) return -1;
        // subtraction-style: ln near 2^64 must not wrap (i <= n holds
        // after read_varint)
        if (ln > n - i) return -1;
        o = i;
        l = ln;
        i += ln;
        break;
      }
      case 5: {
        if (n - i < 4) return -1;
        l = 4;
        i += 4;
        break;
      }
      default:
        return -5;
    }
    field_num[count] = field;
    wire_type[count] = static_cast<uint8_t>(wire);
    off[count] = o;
    len[count] = l;
    value[count] = v;
    ++count;
  }
  return count;
}

// Decode a packed-varint payload into uint64 values.  Returns the count
// or -1 on truncation, -4 if out is too small.
int64_t en_decode_varints(const uint8_t* buf, uint64_t n, uint64_t* out,
                          int64_t max_values) {
  uint64_t i = 0;
  int64_t count = 0;
  while (i < n) {
    uint64_t v;
    if (!read_varint(buf, n, &i, &v)) return -1;
    if (count >= max_values) return -4;
    out[count++] = v;
  }
  return count;
}

}  // extern "C"
