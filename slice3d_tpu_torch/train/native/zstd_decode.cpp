// A zstd decoder (RFC 8878) and CRC-32C, for reading the JAX package's orbax
// checkpoint directories: OCDBT files and zarr chunks are zstd frames, and
// every OCDBT file ends in a CRC-32C of what comes before it.
//
// The decoder takes whole frames (several back to back, skippable frames
// among them) from one buffer into one output buffer of a known capacity:
// raw, RLE and compressed blocks; literals raw, RLE, Huffman-coded (weights
// given directly or FSE-coded) or "treeless" (the previous block's table), in
// 1 or 4 streams; sequences with predefined, RLE, FSE-coded and repeat tables;
// the three repeat offsets; and the XXH64 content checksum.  A frame that
// needs a dictionary is refused.  Every read of the input and every write and
// match copy of the output is checked against its buffer: bad input returns a
// negative code and a message, never a read or write out of bounds.
//
// Entry points (C, bound with ctypes; no global state, so any number of
// threads may decode at once):
//   int64_t s3d_zstd_decompress(src, src_size, dst, dst_capacity, err, err_len)
//     -> bytes written, or -1 with a message in err (-2: dst too small).
//   int64_t s3d_zstd_content_size(src, src_size)
//     -> the sum of the frames' declared content sizes; -1 if a frame
//        declares none; -3 if the frames cannot be walked.
//   uint32_t s3d_crc32c(data, size)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdarg>
#include <vector>

namespace {

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr int kBlockMax = 128 * 1024;
constexpr int kHufMaxBits = 11;
constexpr int kMaxLL = 35, kMaxML = 52, kMaxOF = 31;
constexpr int kLLMaxLog = 9, kMLMaxLog = 9, kOFMaxLog = 8;

struct Error {
  int code;
};

struct Ctx {
  char* err;
  int err_len;
};

[[noreturn]] void fail(Ctx& ctx, int code, const char* fmt, ...) {
  if (ctx.err && ctx.err_len > 0) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(ctx.err, ctx.err_len, fmt, ap);
    va_end(ap);
  }
  throw Error{code};
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline uint64_t rd64(const uint8_t* p) { return (uint64_t)rd32(p) | ((uint64_t)rd32(p + 4) << 32); }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// n (<= 57) bits of a little-endian bit string starting at bit pos; bits
// before the start or past the end of the buffer read as 0.
inline uint64_t bits_at(const uint8_t* p, int64_t size, int64_t pos, int n) {
  if (n == 0) return 0;
  const uint64_t mask = (n == 64) ? ~0ull : ((1ull << n) - 1);
  int64_t byte = pos >> 3;  // floor, also for pos < 0
  uint64_t w;
  if (pos >= 0 && byte + 8 <= size) {
    memcpy(&w, p + byte, 8);  // little-endian hosts only (x86-64, aarch64)
  } else {
    w = 0;
    for (int i = 0; i < 8; ++i) {
      int64_t b = byte + i;
      if (b >= 0 && b < size) w |= (uint64_t)p[b] << (8 * i);
    }
  }
  return (w >> (pos & 7)) & mask;
}

// A bit stream read backwards (Huffman and FSE payloads): it starts below the
// highest set bit of its last byte, and reads downwards; reading past its
// start yields zeros and leaves pos negative, which the caller checks.
struct BackBits {
  const uint8_t* p;
  int64_t size;
  int64_t pos;
  void init(Ctx& ctx, const uint8_t* data, int64_t n, const char* what) {
    p = data;
    size = n;
    if (n <= 0) fail(ctx, -1, "corrupt zstd data: empty %s bit stream", what);
    uint8_t last = data[n - 1];
    if (last == 0) fail(ctx, -1, "corrupt zstd data: %s bit stream has no end mark", what);
    pos = (n - 1) * 8 + highbit(last);
  }
  inline uint64_t read(int n) {
    pos -= n;
    return bits_at(p, size, pos, n);
  }
  inline uint64_t peek(int n) const { return bits_at(p, size, pos - n, n); }
  inline void skip(int n) { pos -= n; }
};

// -- FSE ---------------------------------------------------------------------

struct FseEntry {
  uint16_t base;  // the next state's base
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool valid = false;
};

// Reads a normalised distribution (RFC 8878 4.1.1); returns bytes used.
int64_t read_ncount(Ctx& ctx, const uint8_t* src, int64_t size, int max_symbol, int max_log,
                    int16_t* norm, int* n_symbols, int* log_out) {
  int64_t pos = 0;  // bit position
  if (size <= 0) fail(ctx, -1, "corrupt zstd data: missing FSE table description");
  int log = (int)bits_at(src, size, pos, 4) + 5;
  pos += 4;
  if (log > max_log) fail(ctx, -1, "corrupt zstd data: FSE accuracy log %d above %d", log, max_log);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  int symbol = 0;
  while (remaining > 1) {
    if (symbol > max_symbol) fail(ctx, -1, "corrupt zstd data: FSE table has too many symbols");
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint64_t low = bits_at(src, size, pos, nbits - 1);
    if ((int)low < max) {
      count = (int)low;
      pos += nbits - 1;
    } else {
      count = (int)bits_at(src, size, pos, nbits);
      if (count >= threshold) count -= max;
      pos += nbits;
    }
    count -= 1;  // probability: -1 means "less than 1"
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = (int16_t)count;
    if (count == 0) {
      for (;;) {
        int rep = (int)bits_at(src, size, pos, 2);
        pos += 2;
        for (int i = 0; i < rep; ++i) {
          if (symbol > max_symbol) fail(ctx, -1, "corrupt zstd data: FSE zero run too long");
          norm[symbol++] = 0;
        }
        if (rep != 3) break;
        if (pos > size * 8) fail(ctx, -1, "corrupt zstd data: FSE table description truncated");
      }
    }
    while (remaining < threshold && threshold > 1) {
      --nbits;
      threshold >>= 1;
    }
    if (pos > size * 8) fail(ctx, -1, "corrupt zstd data: FSE table description truncated");
  }
  if (remaining != 1) fail(ctx, -1, "corrupt zstd data: FSE probabilities do not sum up");
  *n_symbols = symbol;
  *log_out = log;
  return (pos + 7) >> 3;
}

void build_fse(Ctx& ctx, FseTable& out, const int16_t* norm, int n_symbols, int log) {
  const int size = 1 << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(n_symbols);
  int high = size - 1;
  for (int s = 0; s < n_symbols; ++s) {
    if (norm[s] == -1) {
      out.t[high--].symbol = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n_symbols; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[pos].symbol = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail(ctx, -1, "corrupt zstd data: FSE table does not spread");
  for (int u = 0; u < size; ++u) {
    int s = out.t[u].symbol;
    uint32_t n = next[s]++;
    if (n == 0) fail(ctx, -1, "corrupt zstd data: FSE table is inconsistent");
    int bits = log - highbit(n);
    out.t[u].bits = (uint8_t)bits;
    out.t[u].base = (uint16_t)((n << bits) - size);
  }
  out.valid = true;
}

void build_rle(FseTable& out, uint8_t symbol) {
  out.log = 0;
  out.t.assign(1, FseEntry{0, symbol, 0});
  out.valid = true;
}

// -- Huffman -----------------------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufEntry> t;
  bool valid = false;
};

// Reads a Huffman tree description; returns bytes used.
int64_t read_huffman(Ctx& ctx, HufTable& out, const uint8_t* src, int64_t size) {
  if (size < 1) fail(ctx, -1, "corrupt zstd data: missing Huffman tree description");
  uint8_t weights[256];
  int n_weights = 0;
  int header = src[0];
  int64_t used;
  if (header < 128) {  // FSE-coded weights, `header` bytes
    used = 1 + header;
    if (used > size) fail(ctx, -1, "corrupt zstd data: Huffman weights truncated");
    int16_t norm[16];
    int n_symbols, log;
    int64_t n = read_ncount(ctx, src + 1, header, 15, 6, norm, &n_symbols, &log);
    FseTable table;
    build_fse(ctx, table, norm, n_symbols, log);
    BackBits bits;
    bits.init(ctx, src + 1 + n, header - n, "Huffman weights");
    uint32_t s1 = (uint32_t)bits.read(log), s2 = (uint32_t)bits.read(log);
    for (;;) {
      if (n_weights > 254) fail(ctx, -1, "corrupt zstd data: too many Huffman weights");
      const FseEntry& e1 = table.t[s1];
      weights[n_weights++] = e1.symbol;
      s1 = e1.base + (uint32_t)bits.read(e1.bits);
      if (bits.pos < 0) {
        if (n_weights > 254) fail(ctx, -1, "corrupt zstd data: too many Huffman weights");
        weights[n_weights++] = table.t[s2].symbol;
        break;
      }
      if (n_weights > 254) fail(ctx, -1, "corrupt zstd data: too many Huffman weights");
      const FseEntry& e2 = table.t[s2];
      weights[n_weights++] = e2.symbol;
      s2 = e2.base + (uint32_t)bits.read(e2.bits);
      if (bits.pos < 0) {
        if (n_weights > 254) fail(ctx, -1, "corrupt zstd data: too many Huffman weights");
        weights[n_weights++] = table.t[s1].symbol;
        break;
      }
    }
  } else {  // 4-bit weights, packed two to a byte
    n_weights = header - 127;
    used = 1 + (n_weights + 1) / 2;
    if (used > size) fail(ctx, -1, "corrupt zstd data: Huffman weights truncated");
    for (int i = 0; i < n_weights; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  }
  // the last weight is implied: it completes the sum to a power of two
  uint32_t total = 0;
  for (int i = 0; i < n_weights; ++i) {
    if (weights[i] > kHufMaxBits) fail(ctx, -1, "corrupt zstd data: Huffman weight %d", weights[i]);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(ctx, -1, "corrupt zstd data: Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  if (max_bits > kHufMaxBits) fail(ctx, -1, "corrupt zstd data: Huffman code longer than 11 bits");
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail(ctx, -1, "corrupt zstd data: Huffman weights do not sum up");
  if (n_weights >= 256) fail(ctx, -1, "corrupt zstd data: too many Huffman symbols");
  weights[n_weights++] = (uint8_t)(highbit(left) + 1);
  out.max_bits = max_bits;
  out.t.assign(1u << max_bits, HufEntry{0, 0});
  // lowest weight first, symbols in order within a weight
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    uint32_t span = 1u << (w - 1);
    for (int s = 0; s < n_weights; ++s) {
      if (weights[s] != w) continue;
      HufEntry e{(uint8_t)s, (uint8_t)(max_bits + 1 - w)};
      for (uint32_t i = 0; i < span; ++i) out.t[pos + i] = e;
      pos += span;
    }
  }
  out.valid = true;
  return used;
}

struct HufStream {
  BackBits bits;
  uint8_t* dst;
  int64_t n;
  int64_t i;
};

// One load of the 57 bits below the stream's position serves 57 / max_bits
// symbols (a symbol is at most max_bits long).
inline void huf_load(HufStream& s, const HufEntry* t, int mb, uint64_t mask, int per_load) {
  const int64_t lo = s.bits.pos - 57;
  uint64_t w;
  memcpy(&w, s.bits.p + (lo >> 3), 8);  // lo >= 0, lo >> 3 <= size - 8: see bits_at
  w >>= (lo & 7);
  int avail = 57;
  uint8_t* d = s.dst + s.i;
  for (int k = 0; k < per_load; ++k) {
    const HufEntry& e = t[(w >> (avail - mb)) & mask];
    d[k] = e.symbol;
    avail -= e.bits;
  }
  s.i += per_load;
  s.bits.pos -= 57 - avail;
}

// Decodes `count` independent Huffman streams, interleaved while every one has
// room for a whole load, then each to its end.
void huf_streams(Ctx& ctx, const HufTable& h, HufStream* s, int count) {
  const int mb = h.max_bits;
  const HufEntry* t = h.t.data();
  const uint64_t mask = (1ull << mb) - 1;
  const int per_load = 57 / mb;
  auto room = [&](const HufStream& x) { return x.bits.pos >= 57 && x.n - x.i >= per_load; };
  if (count == 4) {
    while (room(s[0]) && room(s[1]) && room(s[2]) && room(s[3])) {
      huf_load(s[0], t, mb, mask, per_load);
      huf_load(s[1], t, mb, mask, per_load);
      huf_load(s[2], t, mb, mask, per_load);
      huf_load(s[3], t, mb, mask, per_load);
    }
  }
  for (int k = 0; k < count; ++k) {
    HufStream& x = s[k];
    while (room(x)) huf_load(x, t, mb, mask, per_load);
    for (; x.i < x.n; ++x.i) {
      const HufEntry& e = t[x.bits.peek(mb)];
      x.dst[x.i] = e.symbol;
      x.bits.skip(e.bits);
    }
    if (x.bits.pos != 0)
      fail(ctx, -1, "corrupt zstd data: Huffman stream does not end where it should");
  }
}

// -- sequences ---------------------------------------------------------------

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// Reads one of the three sequence tables in `mode`; returns bytes used.
int64_t read_seq_table(Ctx& ctx, FseTable& table, int mode, const uint8_t* src, int64_t size,
                       const int16_t* def_norm, int def_n, int def_log, int max_symbol,
                       int max_log, const char* what) {
  switch (mode) {
    case 0:
      build_fse(ctx, table, def_norm, def_n, def_log);
      return 0;
    case 1:
      if (size < 1) fail(ctx, -1, "corrupt zstd data: %s RLE symbol missing", what);
      if (src[0] > max_symbol) fail(ctx, -1, "corrupt zstd data: %s RLE symbol %d", what, src[0]);
      build_rle(table, src[0]);
      return 1;
    case 2: {
      int16_t norm[64];
      int n_symbols, log;
      int64_t n = read_ncount(ctx, src, size, max_symbol, max_log, norm, &n_symbols, &log);
      build_fse(ctx, table, norm, n_symbols, log);
      return n;
    }
    default:
      if (!table.valid) fail(ctx, -1, "corrupt zstd data: %s repeats a table never given", what);
      return 0;
  }
}

struct Frame {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
};

struct Out {
  uint8_t* base;  // the whole output buffer
  int64_t cap;
  int64_t pos;
  int64_t frame_start;
};

void need(Ctx& ctx, const Out& out, int64_t n) {
  if (n > out.cap - out.pos) fail(ctx, -2, "zstd output larger than the %lld bytes expected",
                                  (long long)out.cap);
}

// Decodes the literals section; returns bytes used, the literals in f.lit.
int64_t read_literals(Ctx& ctx, Frame& f, const uint8_t* src, int64_t size, int64_t* n_lit) {
  if (size < 1) fail(ctx, -1, "corrupt zstd data: block without literals section");
  int type = src[0] & 3;
  int fmt = (src[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    int64_t regen, hsize;
    if (fmt == 0 || fmt == 2) {
      regen = src[0] >> 3;
      hsize = 1;
    } else if (fmt == 1) {
      if (size < 2) fail(ctx, -1, "corrupt zstd data: literals header truncated");
      regen = (src[0] >> 4) + (src[1] << 4);
      hsize = 2;
    } else {
      if (size < 3) fail(ctx, -1, "corrupt zstd data: literals header truncated");
      regen = (src[0] >> 4) + (src[1] << 4) + ((int64_t)src[2] << 12);
      hsize = 3;
    }
    if (regen > kBlockMax) fail(ctx, -1, "corrupt zstd data: literals larger than a block");
    *n_lit = regen;
    if (type == 0) {
      if (hsize + regen > size) fail(ctx, -1, "corrupt zstd data: raw literals truncated");
      memcpy(f.lit.data(), src + hsize, regen);
      return hsize + regen;
    }
    if (hsize + 1 > size) fail(ctx, -1, "corrupt zstd data: RLE literal missing");
    memset(f.lit.data(), src[hsize], regen);
    return hsize + 1;
  }
  // Huffman-coded (2) or treeless (3)
  int64_t regen, comp, hsize;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt <= 1) {
    if (size < 3) fail(ctx, -1, "corrupt zstd data: literals header truncated");
    uint32_t v = rd24(src);
    regen = (v >> 4) & 0x3FF;
    comp = (v >> 14) & 0x3FF;
    hsize = 3;
  } else if (fmt == 2) {
    if (size < 4) fail(ctx, -1, "corrupt zstd data: literals header truncated");
    uint32_t v = rd32(src);
    regen = (v >> 4) & 0x3FFF;
    comp = (v >> 18) & 0x3FFF;
    hsize = 4;
  } else {
    if (size < 5) fail(ctx, -1, "corrupt zstd data: literals header truncated");
    uint64_t v = rd32(src) | ((uint64_t)src[4] << 32);
    regen = (v >> 4) & 0x3FFFF;
    comp = (v >> 22) & 0x3FFFF;
    hsize = 5;
  }
  if (regen > kBlockMax) fail(ctx, -1, "corrupt zstd data: literals larger than a block");
  if (hsize + comp > size) fail(ctx, -1, "corrupt zstd data: compressed literals truncated");
  const uint8_t* p = src + hsize;
  int64_t left = comp;
  if (type == 2) {
    int64_t n = read_huffman(ctx, f.huf, p, left);
    p += n;
    left -= n;
  } else if (!f.huf.valid) {
    fail(ctx, -1, "corrupt zstd data: treeless literals before any Huffman table");
  }
  *n_lit = regen;
  if (streams == 1) {
    HufStream one;
    one.bits.init(ctx, p, left, "Huffman");
    one.dst = f.lit.data(), one.n = regen, one.i = 0;
    huf_streams(ctx, f.huf, &one, 1);
  } else {
    if (left < 6) fail(ctx, -1, "corrupt zstd data: literals jump table truncated");
    int64_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    int64_t s4 = left - 6 - s1 - s2 - s3;
    if (s4 < 0) fail(ctx, -1, "corrupt zstd data: literals streams overrun their section");
    int64_t part = (regen + 3) / 4;
    int64_t last = regen - 3 * part;
    if (last < 0) fail(ctx, -1, "corrupt zstd data: too few literals for four streams");
    const uint8_t* q = p + 6;
    uint8_t* d = f.lit.data();
    const int64_t sizes[4] = {s1, s2, s3, s4};
    HufStream four[4];
    for (int k = 0; k < 4; ++k) {
      four[k].bits.init(ctx, q, sizes[k], "Huffman");
      four[k].dst = d + k * part;
      four[k].n = k < 3 ? part : last;
      four[k].i = 0;
      q += sizes[k];
    }
    huf_streams(ctx, f.huf, four, 4);
  }
  return hsize + comp;
}

void copy_match(Ctx& ctx, Out& out, uint32_t offset, uint32_t len) {
  if (offset == 0 || offset > out.pos - out.frame_start)
    fail(ctx, -1, "corrupt zstd data: match offset %u reaches before the frame", offset);
  need(ctx, out, len);
  uint8_t* d = out.base + out.pos;
  const uint8_t* s = d - offset;
  if (offset >= len) {
    memcpy(d, s, len);
  } else {
    for (uint32_t i = 0; i < len; ++i) d[i] = s[i];
  }
  out.pos += len;
}

void compressed_block(Ctx& ctx, Frame& f, Out& out, const uint8_t* src, int64_t size) {
  int64_t n_lit;
  int64_t used = read_literals(ctx, f, src, size, &n_lit);
  const uint8_t* p = src + used;
  int64_t left = size - used;
  if (left < 1) fail(ctx, -1, "corrupt zstd data: sequences section missing");
  int64_t n_seq = p[0];
  if (n_seq < 128) {
    p += 1, left -= 1;
  } else if (n_seq < 255) {
    if (left < 2) fail(ctx, -1, "corrupt zstd data: sequences header truncated");
    n_seq = ((n_seq - 128) << 8) + p[1];
    p += 2, left -= 2;
  } else {
    if (left < 3) fail(ctx, -1, "corrupt zstd data: sequences header truncated");
    n_seq = p[1] + (p[2] << 8) + 0x7F00;
    p += 3, left -= 3;
  }
  const uint8_t* lit = f.lit.data();
  int64_t lit_pos = 0;
  if (n_seq == 0) {
    if (left != 0) fail(ctx, -1, "corrupt zstd data: bytes after an empty sequences section");
    need(ctx, out, n_lit);
    memcpy(out.base + out.pos, lit, n_lit);
    out.pos += n_lit;
    return;
  }
  if (left < 1) fail(ctx, -1, "corrupt zstd data: sequences modes missing");
  int modes = p[0];
  if (modes & 3) fail(ctx, -1, "corrupt zstd data: reserved bits set in sequences modes");
  p += 1, left -= 1;
  int64_t n;
  n = read_seq_table(ctx, f.ll, (modes >> 6) & 3, p, left, kLLNorm, 36, 6, kMaxLL, kLLMaxLog,
                     "literal lengths");
  p += n, left -= n;
  n = read_seq_table(ctx, f.of, (modes >> 4) & 3, p, left, kOFNorm, 29, 5, kMaxOF, kOFMaxLog,
                     "offsets");
  p += n, left -= n;
  n = read_seq_table(ctx, f.ml, (modes >> 2) & 3, p, left, kMLNorm, 53, 6, kMaxML, kMLMaxLog,
                     "match lengths");
  p += n, left -= n;
  BackBits bits;
  bits.init(ctx, p, left, "sequences");
  uint32_t sll = (uint32_t)bits.read(f.ll.log);
  uint32_t sof = (uint32_t)bits.read(f.of.log);
  uint32_t sml = (uint32_t)bits.read(f.ml.log);
  const FseEntry* tll = f.ll.t.data();
  const FseEntry* tof = f.of.t.data();
  const FseEntry* tml = f.ml.t.data();
  uint32_t* rep = f.rep;
  for (int64_t i = 0; i < n_seq; ++i) {
    const FseEntry ell = tll[sll], eof = tof[sof], eml = tml[sml];
    int of_code = eof.symbol, ml_code = eml.symbol, ll_code = ell.symbol;
    if (ll_code > kMaxLL || ml_code > kMaxML || of_code > kMaxOF)
      fail(ctx, -1, "corrupt zstd data: sequence code out of range");
    uint64_t of_value = (1ull << of_code) + bits.read(of_code);
    uint32_t ml = kMLBase[ml_code] + (uint32_t)bits.read(kMLBits[ml_code]);
    uint32_t ll = kLLBase[ll_code] + (uint32_t)bits.read(kLLBits[ll_code]);
    uint32_t offset;
    if (of_value > 3) {
      if (of_value - 3 > 0xFFFFFFFFull) fail(ctx, -1, "corrupt zstd data: offset too large");
      offset = (uint32_t)(of_value - 3);
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      uint32_t idx = (uint32_t)of_value - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < n_seq) {
      sll = ell.base + (uint32_t)bits.read(ell.bits);
      sml = eml.base + (uint32_t)bits.read(eml.bits);
      sof = eof.base + (uint32_t)bits.read(eof.bits);
    }
    if (bits.pos < 0) fail(ctx, -1, "corrupt zstd data: sequences bit stream overrun");
    if (ll > n_lit - lit_pos) fail(ctx, -1, "corrupt zstd data: sequences use more literals than given");
    need(ctx, out, ll);
    memcpy(out.base + out.pos, lit + lit_pos, ll);
    out.pos += ll;
    lit_pos += ll;
    copy_match(ctx, out, offset, ml);
  }
  if (bits.pos != 0) fail(ctx, -1, "corrupt zstd data: sequences bit stream does not end where it should");
  int64_t rest = n_lit - lit_pos;
  need(ctx, out, rest);
  memcpy(out.base + out.pos, lit + lit_pos, rest);
  out.pos += rest;
}

// -- XXH64 -------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, int64_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
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
    h = P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -- frames ------------------------------------------------------------------

struct Header {
  int64_t size;          // header bytes after the magic
  int64_t content_size;  // -1: not declared
  bool checksum;
};

Header frame_header(Ctx& ctx, const uint8_t* p, int64_t left) {
  if (left < 1) fail(ctx, -1, "corrupt zstd data: frame header truncated");
  uint8_t d = p[0];
  int fcs_flag = d >> 6;
  bool single = (d >> 5) & 1;
  if (d & 8) fail(ctx, -1, "corrupt zstd data: reserved bit set in the frame header");
  int dict_flag = d & 3;
  static const int kDictBytes[4] = {0, 1, 2, 4};
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  int fcs_bytes = (fcs_flag == 0 && single) ? 1 : kFcsBytes[fcs_flag];
  int64_t size = 1 + (single ? 0 : 1) + kDictBytes[dict_flag] + fcs_bytes;
  if (left < size) fail(ctx, -1, "corrupt zstd data: frame header truncated");
  Header h{size, -1, (bool)((d >> 2) & 1)};
  // the window descriptor is skipped: the whole frame decodes into one buffer,
  // and a match may reach back to the frame's start
  const uint8_t* q = p + 1 + (single ? 0 : 1);
  uint32_t dict = 0;
  for (int i = 0; i < kDictBytes[dict_flag]; ++i) dict |= (uint32_t)q[i] << (8 * i);
  if (dict != 0)
    fail(ctx, -4, "zstd frame needs dictionary %u: frames with a dictionary are not supported",
         dict);
  q += kDictBytes[dict_flag];
  if (fcs_bytes == 1) h.content_size = q[0];
  else if (fcs_bytes == 2) h.content_size = rd16(q) + 256;
  else if (fcs_bytes == 4) h.content_size = rd32(q);
  else if (fcs_bytes == 8) {
    uint64_t v = rd64(q);
    if (v > (uint64_t)INT64_MAX) fail(ctx, -1, "corrupt zstd data: content size too large");
    h.content_size = (int64_t)v;
  }
  return h;
}

// Decodes one frame at p (after its magic); returns the bytes it used.
int64_t decode_frame(Ctx& ctx, Frame& f, Out& out, const uint8_t* p, int64_t left) {
  Header h = frame_header(ctx, p, left);
  const uint8_t* q = p + h.size;
  left -= h.size;
  out.frame_start = out.pos;
  f.huf.valid = f.ll.valid = f.of.valid = f.ml.valid = false;
  f.rep[0] = 1, f.rep[1] = 4, f.rep[2] = 8;
  for (;;) {
    if (left < 3) fail(ctx, -1, "corrupt zstd data: block header truncated");
    uint32_t bh = rd24(q);
    q += 3, left -= 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    int64_t bsize = bh >> 3;
    if (type == 3) fail(ctx, -1, "corrupt zstd data: reserved block type");
    if (bsize > kBlockMax) fail(ctx, -1, "corrupt zstd data: block larger than 128 KiB");
    if (type == 1) {  // RLE: one byte, repeated bsize times
      if (left < 1) fail(ctx, -1, "corrupt zstd data: RLE block truncated");
      need(ctx, out, bsize);
      memset(out.base + out.pos, q[0], bsize);
      out.pos += bsize;
      q += 1, left -= 1;
    } else {
      if (bsize > left) fail(ctx, -1, "corrupt zstd data: block truncated");
      if (type == 0) {
        need(ctx, out, bsize);
        memcpy(out.base + out.pos, q, bsize);
        out.pos += bsize;
      } else {
        int64_t before = out.pos;
        compressed_block(ctx, f, out, q, bsize);
        if (out.pos - before > kBlockMax)
          fail(ctx, -1, "corrupt zstd data: block decodes to more than 128 KiB");
      }
      q += bsize, left -= bsize;
    }
    if (last) break;
  }
  int64_t produced = out.pos - out.frame_start;
  if (h.content_size >= 0 && produced != h.content_size)
    fail(ctx, -1, "corrupt zstd data: frame decodes to %lld bytes, its header says %lld",
         (long long)produced, (long long)h.content_size);
  if (h.checksum) {
    if (left < 4) fail(ctx, -1, "corrupt zstd data: content checksum truncated");
    uint32_t want = rd32(q);
    uint32_t got = (uint32_t)xxh64(out.base + out.frame_start, produced);
    if (want != got) fail(ctx, -1, "zstd content checksum mismatch");
    q += 4, left -= 4;
  }
  return q - p;
}

uint32_t kCrcTable[8][256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      kCrcTable[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t)
        kCrcTable[t][i] = (kCrcTable[t - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[t - 1][i] & 0xFF];
  }
} kCrcInit;

}  // namespace

extern "C" {

int64_t s3d_zstd_decompress(const uint8_t* src, int64_t src_size, uint8_t* dst,
                            int64_t dst_capacity, char* err, int err_len) {
  Ctx ctx{err, err_len};
  Out out{dst, dst_capacity, 0, 0};
  try {
    Frame f;
    f.lit.resize(kBlockMax);
    int64_t pos = 0;
    if (src_size <= 0) fail(ctx, -1, "empty input: not a zstd frame");
    while (pos < src_size) {
      if (src_size - pos < 4) fail(ctx, -1, "corrupt zstd data: %lld stray bytes after a frame",
                                   (long long)(src_size - pos));
      uint32_t magic = rd32(src + pos);
      pos += 4;
      if ((magic & kSkippableMask) == kSkippableMagic) {
        if (src_size - pos < 4) fail(ctx, -1, "corrupt zstd data: skippable frame truncated");
        int64_t n = rd32(src + pos);
        pos += 4;
        if (n > src_size - pos) fail(ctx, -1, "corrupt zstd data: skippable frame truncated");
        pos += n;
        continue;
      }
      if (magic != kFrameMagic)
        fail(ctx, -1, "not a zstd frame: magic 0x%08x at byte %lld", magic, (long long)(pos - 4));
      pos += decode_frame(ctx, f, out, src + pos, src_size - pos);
    }
    return out.pos;
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    if (err && err_len > 0) snprintf(err, err_len, "zstd decoder ran out of memory");
    return -1;
  }
}

int64_t s3d_zstd_content_size(const uint8_t* src, int64_t src_size) {
  Ctx ctx{nullptr, 0};
  try {
    int64_t pos = 0, total = 0;
    bool known = true;
    while (pos < src_size) {
      if (src_size - pos < 8) return -3;
      uint32_t magic = rd32(src + pos);
      pos += 4;
      if ((magic & kSkippableMask) == kSkippableMagic) {
        int64_t n = rd32(src + pos);
        pos += 4 + n;
        continue;
      }
      if (magic != kFrameMagic) return -3;
      Header h = frame_header(ctx, src + pos, src_size - pos);
      if (h.content_size < 0) known = false;
      else total += h.content_size;
      pos += h.size;
      for (;;) {  // walk the block headers to the frame's end
        if (src_size - pos < 3) return -3;
        uint32_t bh = rd24(src + pos);
        pos += 3;
        int type = (bh >> 1) & 3;
        pos += type == 1 ? 1 : (int64_t)(bh >> 3);
        if (pos > src_size) return -3;
        if (bh & 1) break;
      }
      if (h.checksum) pos += 4;
    }
    if (pos > src_size) return -3;
    return known ? total : -1;
  } catch (const Error&) {
    return -3;
  }
}

uint32_t s3d_crc32c(const uint8_t* p, int64_t n) {
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo = rd32(p) ^ c, hi = rd32(p + 4);
    c = kCrcTable[7][lo & 0xFF] ^ kCrcTable[6][(lo >> 8) & 0xFF] ^
        kCrcTable[5][(lo >> 16) & 0xFF] ^ kCrcTable[4][lo >> 24] ^
        kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
        kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    p += 8, n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ kCrcTable[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
