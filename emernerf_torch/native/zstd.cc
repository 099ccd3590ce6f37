// A zstd frame decoder (RFC 8878) for the port's checkpoint reader.
//
// The JAX package's orbax checkpoints compress every zarr chunk and every
// OCDBT node with zstd; the card's machine has no zstd library, so the
// reader (emernerf_torch/train/orbax_read.py) decodes with this file,
// bound through ctypes by emernerf_torch/native/zstd.py.  Its plain
// version is emernerf_torch/native/zstd_plain.py, which follows the same
// steps in the same order; tests/test_torch_zstd.py holds the two to each
// other and to the zstandard library.
//
// Covered: the frame header with and without a content size, the window,
// the optional XXH64 content checksum (verified), raw, RLE and compressed
// blocks, the literals section (raw, RLE, Huffman with 1 or 4 streams,
// treeless sections that reuse the previous table), the sequences' FSE
// tables (predefined, RLE, compressed, repeat), the three repeat offsets,
// skippable frames.  A frame that names a dictionary is refused.
//
//   emz_decompress(src, n, dst, cap)  every frame of src into dst; returns
//                                     the bytes written or a negative code
//   emz_content_size(src, n)          the first frame's content size, -1 if
//                                     the header has none, or a code
//   emz_error(code)                   the message of a code
//   emz_xxh64(p, n, seed)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC zstd.cc -o libemzstd.so

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

enum Err : int64_t {
  kTruncated = -1,
  kBadMagic = -2,
  kReserved = -3,
  kDictionary = -4,
  kWindow = -5,
  kBlockSize = -6,
  kCorruptLiterals = -7,
  kCorruptHuffman = -8,
  kCorruptFse = -9,
  kCorruptSequences = -10,
  kOffset = -11,
  kOverflow = -12,
  kContentSize = -13,
  kChecksum = -14,
  kNoTable = -15,
  kEmpty = -16,
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u, kSkippable = 0x184D2A50u;
constexpr int64_t kBlockMax = 1 << 17;
constexpr int kWindowLogMax = 31;

struct Fail {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Fail{code}; }

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

// ------------------------------------------------------------------ XXH64
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round64(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }
inline uint64_t u64_at(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

uint64_t xxh64(const uint8_t* p, uint64_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (p + 32 <= end) {
      v1 = round64(v1, u64_at(p));
      v2 = round64(v2, u64_at(p + 8));
      v3 = round64(v3, u64_at(p + 16));
      v4 = round64(v4, u64_at(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    const uint64_t lanes[4] = {v1, v2, v3, v4};
    for (uint64_t v : lanes) h = (h ^ round64(0, v)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= round64(0, u64_at(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    h ^= uint64_t(v) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ------------------------------------------------------------- bit readers
// Forward: bits from the start, least significant first (FSE descriptions).
struct Forward {
  const uint8_t* p;
  int64_t pos, end;  // in bits
  uint32_t read(int n) {
    if (pos + n > end) fail(kCorruptFse);
    uint64_t v = 0;
    int64_t lo = pos >> 3, hi = (pos + n + 7) >> 3;
    for (int64_t b = hi - 1; b >= lo; --b) v = (v << 8) | p[b];
    v >>= (pos & 7);
    pos += n;
    return uint32_t(v & ((1ull << n) - 1));
  }
  uint32_t peek(int n) {
    int64_t save = pos;
    if (pos + n > end) n = int(end - pos);
    uint32_t v = read(n);
    pos = save;
    return v;
  }
};

// Backward: a zstd bitstream, read from its end mark towards its start,
// most significant first; past the start it gives zeros and `left` turns
// negative.
struct Backward {
  const uint8_t* start;
  int64_t size;  // bytes
  int64_t left;  // bits not yet read
  Backward(const uint8_t* s, int64_t n) : start(s), size(n) {
    if (n <= 0 || s[n - 1] == 0) fail(kCorruptSequences);
    int top = 31 - __builtin_clz(uint32_t(s[n - 1]));
    left = (n - 1) * 8 + top;
  }
  // the n (<= 32) bits below `left`, zeros past the start
  inline uint64_t bits_at(int64_t lo, int n) const {
    int pad = 0;
    if (lo < 0) {
      pad = int(-lo);
      n -= pad;
      lo = 0;
      if (n <= 0) return 0;
    }
    int64_t b = lo >> 3;
    uint64_t v;
    if (b + 8 <= size) {
      std::memcpy(&v, start + b, 8);
    } else {
      v = load_le(start + b, int(size - b));
    }
    v = (v >> (lo & 7)) & ((1ull << n) - 1);
    return v << pad;
  }
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    left -= n;
    return uint32_t(bits_at(left, n));
  }
  inline uint32_t peek(int n) const { return uint32_t(bits_at(left - n, n)); }
};

// ------------------------------------------------------------------ FSE
struct FseEntry {
  uint8_t symbol, bits;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: none yet
  FseEntry e[1 << 9];
};

// An FSE table description at p[0:n]: fills counts, returns its byte size.
int64_t read_fse_description(const uint8_t* p, int64_t n, int max_symbol, int max_log,
                             int16_t* counts, int* nsym, int* log_out) {
  Forward br{p, 0, n * 8};
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail(kCorruptFse);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, s = 0;
  while (remaining > 1) {
    if (s > max_symbol) fail(kCorruptFse);
    int mx = (2 * threshold - 1) - remaining;
    int v = int(br.peek(nbits));
    int count;
    if ((v & (threshold - 1)) < mx) {
      count = v & (threshold - 1);
      br.read(nbits - 1);
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= mx;
      br.read(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    counts[s++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        int rep = int(br.read(2));
        for (int i = 0; i < rep; ++i) {
          if (s > max_symbol) fail(kCorruptFse);
          counts[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || s > max_symbol + 1) fail(kCorruptFse);
  *nsym = s;
  *log_out = log;
  return (br.pos + 7) >> 3;
}

void build_fse_table(int log, const int16_t* counts, int nsym, FseTable* t) {
  int size = 1 << log, high = size - 1;
  uint8_t symbol[1 << 9];
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (counts[s] == -1) {
      symbol[high--] = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(counts[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      symbol[pos] = uint8_t(s);
      do {
        pos = (pos + step) & (size - 1);
      } while (pos > high);
    }
  }
  if (pos != 0) fail(kCorruptFse);
  for (int u = 0; u < size; ++u) {
    int s = symbol[u];
    int state = next[s]++;
    int nb = log - (31 - __builtin_clz(uint32_t(state)));
    t->e[u] = FseEntry{uint8_t(s), uint8_t(nb), uint16_t((state << nb) - size)};
  }
  t->log = log;
}

void rle_table(int symbol, FseTable* t) {
  t->log = 0;
  t->e[0] = FseEntry{uint8_t(symbol), 0, 0};
}

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Defaults {
  FseTable ll, ml, of;
  Defaults() {
    build_fse_table(6, kLLDefault, 36, &ll);
    build_fse_table(6, kMLDefault, 53, &ml);
    build_fse_table(5, kOFDefault, 29, &of);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// -------------------------------------------------------------- Huffman
struct HufEntry {
  uint8_t symbol, bits;
};

struct HufTable {
  int max_bits = 0;  // 0: none yet
  HufEntry e[1 << 11];
};

// The Huffman tree description at p[0:n]: builds t, returns its byte size.
int64_t read_huffman(const uint8_t* p, int64_t n, HufTable* t) {
  if (n < 1) fail(kCorruptHuffman);
  uint8_t w[256];
  int nw = 0;
  int head = p[0];
  int64_t used;
  if (head >= 128) {
    nw = head - 127;
    int64_t nbytes = (nw + 1) / 2;
    if (1 + nbytes > n) fail(kCorruptHuffman);
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i % 2 == 0) ? uint8_t(b >> 4) : uint8_t(b & 15);
    }
    used = 1 + nbytes;
  } else {
    if (1 + head > n) fail(kCorruptHuffman);
    int16_t counts[256];
    int nsym, log;
    int64_t d = read_fse_description(p + 1, head, 255, 6, counts, &nsym, &log);
    FseTable table;
    build_fse_table(log, counts, nsym, &table);
    Backward br(p + 1 + d, head - d);
    uint32_t st[2] = {br.read(log), br.read(log)};
    int cur = 0;
    for (;;) {  // two interleaved states until the stream runs out
      const FseEntry& e = table.e[st[cur]];
      if (nw >= 255) fail(kCorruptHuffman);
      w[nw++] = e.symbol;
      st[cur] = e.base + br.read(e.bits);
      if (br.left < 0) {
        if (nw >= 255) fail(kCorruptHuffman);
        w[nw++] = table.e[st[1 - cur]].symbol;
        break;
      }
      cur ^= 1;
    }
    used = 1 + head;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 12) fail(kCorruptHuffman);
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail(kCorruptHuffman);
  int max_bits = 32 - __builtin_clz(total);
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(kCorruptHuffman);
  if (max_bits > 11) fail(kCorruptHuffman);
  w[nw++] = uint8_t(32 - __builtin_clz(rest));
  int pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != wt) continue;
      int cnt = 1 << (wt - 1);
      HufEntry e{uint8_t(s), uint8_t(max_bits + 1 - wt)};
      for (int i = 0; i < cnt; ++i) t->e[pos++] = e;
    }
  }
  t->max_bits = max_bits;
  return used;
}

void huffman_stream(const uint8_t* p, int64_t n, const HufTable& t, uint8_t* out, int64_t count) {
  if (n <= 0) fail(kCorruptHuffman);
  Backward br(p, n);
  const int mb = t.max_bits;
  for (int64_t i = 0; i < count; ++i) {
    const HufEntry& e = t.e[br.peek(mb)];
    out[i] = e.symbol;
    br.left -= e.bits;
  }
  if (br.left != 0) fail(kCorruptHuffman);
}

// ---------------------------------------------------------------- frames
struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool has_ll = false, has_of = false, has_ml = false;
  uint64_t reps[3] = {1, 4, 8};
};

// The literals section at p[0:n] into lits; returns its byte size.
int64_t literals(const uint8_t* p, int64_t n, FrameState& fr, uint8_t* lits, int64_t* nlits) {
  if (n < 1) fail(kCorruptLiterals);
  int kind = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (kind <= 1) {
    int64_t size, h;
    if (fmt == 0 || fmt == 2) {
      size = p[0] >> 3;
      h = 1;
    } else if (fmt == 1) {
      if (n < 2) fail(kCorruptLiterals);
      size = (p[0] >> 4) + (int64_t(p[1]) << 4);
      h = 2;
    } else {
      if (n < 3) fail(kCorruptLiterals);
      size = (p[0] >> 4) + (int64_t(p[1]) << 4) + (int64_t(p[2]) << 12);
      h = 3;
    }
    if (size > kBlockMax) fail(kCorruptLiterals);
    *nlits = size;
    if (kind == 0) {
      if (h + size > n) fail(kCorruptLiterals);
      std::memcpy(lits, p + h, size_t(size));
      return h + size;
    }
    if (h + 1 > n) fail(kCorruptLiterals);
    std::memset(lits, p[h], size_t(size));
    return h + 1;
  }
  int nhead = fmt <= 1 ? 3 : fmt + 2;
  if (nhead > n) fail(kCorruptLiterals);
  uint64_t hv = load_le(p, nhead);
  int bits = nhead == 3 ? 10 : nhead == 4 ? 14 : 18;
  int64_t regen = int64_t((hv >> 4) & ((1ull << bits) - 1));
  int64_t comp = int64_t((hv >> (4 + bits)) & ((1ull << bits) - 1));
  int streams = fmt == 0 ? 1 : 4;
  if (nhead + comp > n || regen > kBlockMax) fail(kCorruptLiterals);
  const uint8_t* q = p + nhead;
  int64_t m = comp;
  if (kind == 2) {
    int64_t used = read_huffman(q, m, &fr.huf);
    q += used;
    m -= used;
  } else if (fr.huf.max_bits == 0) {
    fail(kNoTable);
  }
  if (streams == 1) {
    huffman_stream(q, m, fr.huf, lits, regen);
  } else {
    if (m < 6) fail(kCorruptLiterals);
    int64_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
    q += 6;
    m -= 6;
    int64_t s4 = m - s1 - s2 - s3;
    if (s4 < 1) fail(kCorruptLiterals);
    int64_t per = (regen + 3) / 4;
    if (3 * per > regen) fail(kCorruptLiterals);
    const int64_t sizes[4] = {s1, s2, s3, s4};
    const int64_t counts[4] = {per, per, per, regen - 3 * per};
    uint8_t* o = lits;
    for (int i = 0; i < 4; ++i) {
      huffman_stream(q, sizes[i], fr.huf, o, counts[i]);
      q += sizes[i];
      o += counts[i];
    }
  }
  *nlits = regen;
  return nhead + comp;
}

void sequence_table(const uint8_t*& q, const uint8_t* end, int mode, int max_sym, int max_log,
                    const FseTable& def, FseTable* t, bool* has) {
  if (mode == 0) {
    *t = def;
  } else if (mode == 1) {
    if (q >= end || *q > max_sym) fail(kCorruptSequences);
    rle_table(*q++, t);
  } else if (mode == 2) {
    int16_t counts[64];
    int nsym, log;
    q += read_fse_description(q, end - q, max_sym, max_log, counts, &nsym, &log);
    build_fse_table(log, counts, nsym, t);
  } else if (!*has) {
    fail(kNoTable);
  }
  *has = true;
}

// A compressed block at p[0:n]: its output goes to dst[*o:cap).
void compressed_block(const uint8_t* p, int64_t n, FrameState& fr, uint8_t* dst, int64_t cap,
                      int64_t* o, int64_t frame_start, uint64_t window, uint8_t* lits) {
  int64_t nlits;
  int64_t used = literals(p, n, fr, lits, &nlits);
  const uint8_t* q = p + used;
  const uint8_t* end = p + n;
  if (q >= end) fail(kCorruptSequences);
  int64_t nseq;
  int b0 = *q;
  if (b0 == 0) {
    if (q + 1 != end) fail(kCorruptSequences);
    nseq = 0;
    ++q;
  } else if (b0 < 128) {
    nseq = b0;
    ++q;
  } else if (b0 < 255) {
    if (q + 2 > end) fail(kCorruptSequences);
    nseq = ((b0 - 128) << 8) + q[1];
    q += 2;
  } else {
    if (q + 3 > end) fail(kCorruptSequences);
    nseq = q[1] + (int64_t(q[2]) << 8) + 0x7F00;
    q += 3;
  }
  int64_t out = *o, block_start = *o, lp = 0;
  if (nseq > 0) {
    if (q >= end) fail(kCorruptSequences);
    int modes = *q++;
    if (modes & 3) fail(kReserved);
    const Defaults& d = defaults();
    sequence_table(q, end, (modes >> 6) & 3, 35, 9, d.ll, &fr.ll, &fr.has_ll);
    sequence_table(q, end, (modes >> 4) & 3, 31, 8, d.of, &fr.of, &fr.has_of);
    sequence_table(q, end, (modes >> 2) & 3, 52, 9, d.ml, &fr.ml, &fr.has_ml);
    Backward br(q, end - q);
    uint32_t sll = br.read(fr.ll.log), sof = br.read(fr.of.log), sml = br.read(fr.ml.log);
    uint64_t* reps = fr.reps;
    for (int64_t i = 0; i < nseq; ++i) {
      const FseEntry &el = fr.ll.e[sll], &eo = fr.of.e[sof], &em = fr.ml.e[sml];
      int of_code = eo.symbol;
      if (of_code > 31 || em.symbol > 52 || el.symbol > 35) fail(kCorruptSequences);
      uint64_t value = (1ull << of_code) + br.read(of_code);
      int64_t mlen = kMLBase[em.symbol] + br.read(kMLBits[em.symbol]);
      int64_t llen = kLLBase[el.symbol] + br.read(kLLBits[el.symbol]);
      if (i + 1 < nseq) {
        sll = el.base + br.read(el.bits);
        sml = em.base + br.read(em.bits);
        sof = eo.base + br.read(eo.bits);
      }
      uint64_t offset;
      if (value > 3) {
        offset = value - 3;
        reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      } else {
        int idx = int(value) - 1 + (llen == 0);
        if (idx == 0) {
          offset = reps[0];
        } else {
          offset = idx == 3 ? reps[0] - 1 : reps[idx];
          if (idx > 1) reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        }
      }
      if (lp + llen > nlits) fail(kCorruptSequences);
      if (out + llen + mlen > cap) fail(kOverflow);
      std::memcpy(dst + out, lits + lp, size_t(llen));
      out += llen;
      lp += llen;
      int64_t have = out - frame_start;
      if (offset == 0 || offset > uint64_t(have) || offset > window) fail(kOffset);
      uint8_t* d8 = dst + out;
      const uint8_t* s8 = d8 - offset;
      if (offset >= uint64_t(mlen)) {
        std::memcpy(d8, s8, size_t(mlen));
      } else {
        for (int64_t k = 0; k < mlen; ++k) d8[k] = s8[k];
      }
      out += mlen;
    }
    if (br.left != 0) fail(kCorruptSequences);
  }
  int64_t rest = nlits - lp;
  if (out + rest > cap) fail(kOverflow);
  std::memcpy(dst + out, lits + lp, size_t(rest));
  out += rest;
  if (out - block_start > kBlockMax) fail(kBlockSize);
  *o = out;
}

struct Header {
  int64_t pos;      // after the header
  int64_t content;  // -1: not given
  uint64_t window;
  bool checksum;
};

Header frame_header(const uint8_t* src, int64_t n, int64_t pos) {
  if (pos >= n) fail(kTruncated);
  int fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail(kReserved);
  Header h{0, -1, 0, bool((fhd >> 2) & 1)};
  bool has_window = false;
  if (!single) {
    if (pos >= n) fail(kTruncated);
    int wd = src[pos++];
    int log = 10 + (wd >> 3);
    if (log > kWindowLogMax) fail(kWindow);
    h.window = (1ull << log) + ((1ull << log) >> 3) * uint64_t(wd & 7);
    has_window = true;
  }
  static const int kDid[4] = {0, 1, 2, 4};
  int did = kDid[did_flag];
  if (did) {
    if (pos + did > n) fail(kTruncated);
    if (load_le(src + pos, did)) fail(kDictionary);
    pos += did;
  }
  int fcs = fcs_flag == 0 ? (single ? 1 : 0) : (fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8);
  if (fcs) {
    if (pos + fcs > n) fail(kTruncated);
    h.content = int64_t(load_le(src + pos, fcs)) + (fcs == 2 ? 256 : 0);
    if (h.content < 0) fail(kContentSize);
    pos += fcs;
  }
  if (!has_window) h.window = uint64_t(h.content);
  h.pos = pos;
  return h;
}

int64_t frame(const uint8_t* src, int64_t n, int64_t pos, uint8_t* dst, int64_t cap,
              int64_t* o, FrameState& fr, uint8_t* lits) {
  Header h = frame_header(src, n, pos);
  pos = h.pos;
  const int64_t start = *o;
  if (h.content >= 0 && start + h.content > cap) fail(kOverflow);
  const int64_t block_max = int64_t(h.window) < kBlockMax ? int64_t(h.window) : kBlockMax;
  for (;;) {
    if (pos + 3 > n) fail(kTruncated);
    uint32_t bh = uint32_t(load_le(src + pos, 3));
    pos += 3;
    int last = bh & 1, kind = (bh >> 1) & 3;
    int64_t size = bh >> 3;
    if (kind == 3) fail(kReserved);
    if (size > block_max) fail(kBlockSize);
    if (kind == 0) {
      if (pos + size > n) fail(kTruncated);
      if (*o + size > cap) fail(kOverflow);
      std::memcpy(dst + *o, src + pos, size_t(size));
      *o += size;
      pos += size;
    } else if (kind == 1) {
      if (pos + 1 > n) fail(kTruncated);
      if (*o + size > cap) fail(kOverflow);
      std::memset(dst + *o, src[pos], size_t(size));
      *o += size;
      pos += 1;
    } else {
      if (pos + size > n) fail(kTruncated);
      compressed_block(src + pos, size, fr, dst, cap, o, start, h.window, lits);
      pos += size;
    }
    if (h.content >= 0 && *o - start > h.content) fail(kContentSize);
    if (last) break;
  }
  if (h.content >= 0 && *o - start != h.content) fail(kContentSize);
  if (h.checksum) {
    if (pos + 4 > n) fail(kTruncated);
    uint32_t want = uint32_t(load_le(src + pos, 4));
    if (uint32_t(xxh64(dst + start, uint64_t(*o - start), 0)) != want) fail(kChecksum);
    pos += 4;
  }
  return pos;
}

}  // namespace

extern "C" {

uint64_t emz_xxh64(const uint8_t* p, uint64_t n, uint64_t seed) { return xxh64(p, n, seed); }

int64_t emz_content_size(const uint8_t* src, uint64_t n) {
  try {
    if (n < 4 || load_le(src, 4) != kMagic) return kBadMagic;
    return frame_header(src, int64_t(n), 4).content;
  } catch (const Fail& f) {
    return f.code;
  }
}

int64_t emz_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap) {
  static thread_local uint8_t lits[kBlockMax + 64];
  try {
    if (n == 0) fail(kEmpty);
    int64_t pos = 0, o = 0;
    while (pos < int64_t(n)) {
      if (pos + 4 > int64_t(n)) fail(kTruncated);
      uint32_t magic = uint32_t(load_le(src + pos, 4));
      pos += 4;
      if ((magic & kSkippableMask) == kSkippable) {
        if (pos + 4 > int64_t(n)) fail(kTruncated);
        pos += 4 + int64_t(load_le(src + pos, 4));
        if (pos > int64_t(n)) fail(kTruncated);
        continue;
      }
      if (magic != kMagic) fail(kBadMagic);
      FrameState fr;
      pos = frame(src, int64_t(n), pos, dst, int64_t(cap), &o, fr, lits);
    }
    return o;
  } catch (const Fail& f) {
    return f.code;
  }
}

const char* emz_error(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated zstd input";
    case kBadMagic: return "bad zstd magic";
    case kReserved: return "reserved field set";
    case kDictionary: return "the frame names a dictionary";
    case kWindow: return "window too large";
    case kBlockSize: return "block above its size limit";
    case kCorruptLiterals: return "corrupt literals section";
    case kCorruptHuffman: return "corrupt Huffman stream or table";
    case kCorruptFse: return "corrupt FSE table description";
    case kCorruptSequences: return "corrupt sequences section";
    case kOffset: return "match offset beyond the decoded bytes";
    case kOverflow: return "output larger than the destination";
    case kContentSize: return "frame content size mismatch";
    case kChecksum: return "content checksum mismatch";
    case kNoTable: return "repeat or treeless table with no previous table";
    case kEmpty: return "empty input";
    default: return "unknown zstd error";
  }
}

}  // extern "C"
