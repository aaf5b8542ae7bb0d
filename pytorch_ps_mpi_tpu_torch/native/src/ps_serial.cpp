// ps_serial — native serialization/compression runtime for the TPU PS
// framework.
//
// The reference's byte pipeline is native C via third-party deps: c-blosc
// (byte-shuffle + blosclz, the reference's mpi_comms.py:18-30) applied to
// pickled gradients, plus an unfinished zero-copy path compressing straight
// from the tensor data pointer (the reference's serialization.py:22-23).
// This file is the in-repo equivalent: a byte-shuffle filter and an
// LZ77-family block compressor (blosclz/LZ4-class: greedy hash-table matcher,
// token = literal-run + match-run + 16-bit offset) with a plain C ABI so
// Python binds it with ctypes and passes numpy/jax buffer pointers directly —
// no pickle, no intermediate copies.  ctypes releases the GIL for the call
// duration, so Python-side thread pools get real parallelism across tensors
// (the native analogue of the reference's 200-thread encode pool,
// the reference's ps.py:85).
//
// Format (per compressed buffer, produced by ps_lz_compress):
//   sequence := token(1B) [ext literal lens]* literals [offset(2B LE)
//               [ext match lens]*]
//   token    := (lit_len:4 | match_len:4); 15 in either nibble = extended
//               with 255-continuation bytes; match_len nibble stores
//               (match - MIN_MATCH).  The final sequence is literals-only.
// Self-contained; not the LZ4 on-disk format (no external compatibility
// claims), but the same complexity class: O(n) compress, branch-light
// memcpy-driven decompress.

#include <cstdint>
#include <cstring>
#include <cstddef>

#include <atomic>
#include <mutex>
#include <thread>
#include <vector>

#include <dlfcn.h>

namespace {

constexpr size_t MIN_MATCH = 4;
constexpr size_t MAX_OFFSET = 65535;
constexpr size_t HASH_BITS = 16;
constexpr size_t HASH_SIZE = 1u << HASH_BITS;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) {
  return (v * 2654435761u) >> (32 - HASH_BITS);
}

// Emit a length >= 15 as 255-continuation bytes.
inline uint8_t* put_ext_len(uint8_t* op, size_t len) {
  len -= 15;
  while (len >= 255) {
    *op++ = 255;
    len -= 255;
  }
  *op++ = static_cast<uint8_t>(len);
  return op;
}

inline const uint8_t* get_ext_len(const uint8_t* ip, const uint8_t* iend,
                                  size_t* len) {
  size_t l = 0;
  uint8_t b;
  do {
    if (ip >= iend) return nullptr;
    b = *ip++;
    l += b;
  } while (b == 255);
  *len += l;
  return ip;
}

}  // namespace

extern "C" {

// Worst-case compressed size for n input bytes (store path + headers).
size_t ps_max_compressed(size_t n) { return n + n / 255 + 16; }

// Compress src[0..n) into dst[0..cap). Returns compressed size, or -1 if
// dst is too small (callers should size with ps_max_compressed).
long long ps_lz_compress(const uint8_t* src, size_t n, uint8_t* dst,
                         size_t cap) {
  if (cap < ps_max_compressed(0)) return -1;
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  const uint8_t* anchor = ip;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;

  // Positions of previously seen 4-byte values (offsets from src).
  // 0xFFFFFFFF = empty; n is capped well below that by the framing layer.
  static thread_local uint32_t table[HASH_SIZE];
  std::memset(table, 0xFF, sizeof(table));

  auto emit = [&](const uint8_t* lit_start, size_t lit_len, size_t match_len,
                  size_t offset) -> bool {
    // Worst-case bytes for this sequence.
    size_t need = 1 + lit_len + lit_len / 255 + 1 + 2 + match_len / 255 + 1;
    if (op + need > oend) return false;
    uint8_t token_lit = lit_len >= 15 ? 15 : static_cast<uint8_t>(lit_len);
    if (match_len) {
      size_t m = match_len - MIN_MATCH;
      uint8_t token_match = m >= 15 ? 15 : static_cast<uint8_t>(m);
      *op++ = static_cast<uint8_t>((token_lit << 4) | token_match);
      if (lit_len >= 15) op = put_ext_len(op, lit_len);
      std::memcpy(op, lit_start, lit_len);
      op += lit_len;
      *op++ = static_cast<uint8_t>(offset & 0xFF);
      *op++ = static_cast<uint8_t>(offset >> 8);
      if (m >= 15) op = put_ext_len(op, m);
    } else {  // final literal-only sequence
      *op++ = static_cast<uint8_t>(token_lit << 4);
      if (lit_len >= 15) op = put_ext_len(op, lit_len);
      std::memcpy(op, lit_start, lit_len);
      op += lit_len;
    }
    return true;
  };

  if (n >= MIN_MATCH + 1) {
    const uint8_t* mflimit = iend - MIN_MATCH;
    while (ip <= mflimit) {
      uint32_t h = hash32(read32(ip));
      uint32_t cand = table[h];
      table[h] = static_cast<uint32_t>(ip - src);
      if (cand != 0xFFFFFFFFu) {
        const uint8_t* cp = src + cand;
        size_t offset = static_cast<size_t>(ip - cp);
        if (offset != 0 && offset <= MAX_OFFSET && read32(cp) == read32(ip)) {
          // Extend the match as far as it goes.
          size_t match = MIN_MATCH;
          while (ip + match < iend && cp[match] == ip[match]) ++match;
          if (!emit(anchor, static_cast<size_t>(ip - anchor), match, offset))
            return -1;
          ip += match;
          anchor = ip;
          continue;
        }
      }
      ++ip;
    }
  }
  if (!emit(anchor, static_cast<size_t>(iend - anchor), 0, 0)) return -1;
  return static_cast<long long>(op - dst);
}

// Decompress src[0..n) into dst[0..cap). Returns bytes written, or -1 on
// malformed input / overflow.
long long ps_lz_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;

  while (ip < iend) {
    uint8_t token = *ip++;
    size_t lit_len = token >> 4;
    if (lit_len == 15) {
      ip = get_ext_len(ip, iend, &lit_len);
      if (!ip) return -1;
    }
    if (ip + lit_len > iend || op + lit_len > oend) return -1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // final literals-only sequence
    if (ip + 2 > iend) return -1;
    size_t offset = ip[0] | (static_cast<size_t>(ip[1]) << 8);
    ip += 2;
    size_t match = (token & 0x0F);
    if (match == 15) {
      ip = get_ext_len(ip, iend, &match);
      if (!ip) return -1;
    }
    match += MIN_MATCH;
    if (offset == 0 || op - dst < static_cast<ptrdiff_t>(offset) ||
        op + match > oend)
      return -1;
    // Overlapping copy (offset may be < match): byte loop is required.
    const uint8_t* mp = op - offset;
    for (size_t i = 0; i < match; ++i) op[i] = mp[i];
    op += match;
  }
  return static_cast<long long>(op - dst);
}

// Byte-shuffle filter (c-blosc's shuffle): regroup element bytes by
// significance plane — dst[plane * nelem + e] = src[e * itemsize + plane].
// Narrows the value distribution per plane so the LZ pass finds runs in
// float data. n must be a multiple of itemsize (framing layer guarantees).
void ps_shuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t itemsize) {
  if (itemsize <= 1 || n % itemsize != 0) {
    std::memcpy(dst, src, n);
    return;
  }
  size_t nelem = n / itemsize;
  for (size_t plane = 0; plane < itemsize; ++plane) {
    const uint8_t* s = src + plane;
    uint8_t* d = dst + plane * nelem;
    for (size_t e = 0; e < nelem; ++e) d[e] = s[e * itemsize];
  }
}

void ps_unshuffle(const uint8_t* src, uint8_t* dst, size_t n,
                  size_t itemsize) {
  if (itemsize <= 1 || n % itemsize != 0) {
    std::memcpy(dst, src, n);
    return;
  }
  size_t nelem = n / itemsize;
  for (size_t plane = 0; plane < itemsize; ++plane) {
    const uint8_t* s = src + plane * nelem;
    uint8_t* d = dst + plane;
    for (size_t e = 0; e < nelem; ++e) d[e * itemsize] = s[e];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched tree codec — decode/encode ALL of a pytree's buffer frames in ONE
// GIL-released call.
//
// The per-leaf Python pipeline (header struct.unpack, zlib.crc32, np.empty,
// one ctypes dispatch per leaf) costs ~5 µs/leaf of pure interpreter
// overhead; a 1000-leaf checkpoint paid ~5 ms before any byte moved —
// 4-5x slower than pickle's single C loop.  These entry points walk the
// whole frame sequence natively (crc included, slice-by-8), decode into one
// caller-provided arena at caller-chosen (aligned) offsets, and fan out over
// std::thread for multi-MB payloads — the batch analogue of the reference's
// encode pool (the reference's ps.py:85) without per-task Python dispatch.
// ---------------------------------------------------------------------------

namespace {

constexpr uint8_t FLAG_LZ = 1;
constexpr uint8_t FLAG_SHUFFLE = 2;
constexpr size_t HDR_V2 = 26;  // PSZ2: magic|flags|item|orig|comp|crc32
constexpr size_t HDR_V1 = 22;  // PSZ1: magic|flags|item|orig|comp

// zlib-compatible CRC-32.  The system zlib's SIMD implementation runs
// ~4 GB/s on this host vs ~1.7 GB/s for a plain slice-by-8 loop, so prefer
// it — but resolve it at RUNTIME from the already-present libz.so.1
// (dlopen), never at link time: minimal images ship the runtime library
// without the dev symlink -lz needs, and this build must stay
// zero-dependency.  Slice-by-8 is the always-available fallback.

typedef unsigned long (*zlib_crc32_fn)(unsigned long, const unsigned char*,
                                       unsigned int);

uint32_t crc_tab[8][256];
zlib_crc32_fn zlib_crc32_ptr = nullptr;
std::once_flag crc_once;

void crc_init() {
  void* h = dlopen("libz.so.1", RTLD_LAZY | RTLD_LOCAL);
  if (!h) h = dlopen("libz.so", RTLD_LAZY | RTLD_LOCAL);
  if (h) zlib_crc32_ptr = reinterpret_cast<zlib_crc32_fn>(dlsym(h, "crc32"));
  if (zlib_crc32_ptr) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_tab[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      crc_tab[t][i] =
          (crc_tab[t - 1][i] >> 8) ^ crc_tab[0][crc_tab[t - 1][i] & 0xFF];
}

uint32_t crc32_soft(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
    crc = crc_tab[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    --n;
  }
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    crc ^= lo;
    crc = crc_tab[7][crc & 0xFF] ^ crc_tab[6][(crc >> 8) & 0xFF] ^
          crc_tab[5][(crc >> 16) & 0xFF] ^ crc_tab[4][crc >> 24] ^
          crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF] ^
          crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = crc_tab[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>

// PCLMULQDQ-folded CRC-32 (zlib polynomial, reflected) — the classic
// Gopal/Ozturk/et al. carryless-multiply construction (the same scheme
// zlib-ng/chromium ship).  The system zlib this image carries computes
// crc32 at ~1.1 GB/s (table-driven); on the wire path every multi-MB
// frame is checksummed at BOTH ends, so crc was ~25% of a PS update's
// single-core budget.  This kernel runs at ~10-20 GB/s on any CPU with
// PCLMUL (guarded at runtime; the table path remains the fallback).
//
// Contract: takes and returns the RAW shift register (caller applies
// the ~crc pre/post inversion); len must be >= 64 and a multiple of 16.
__attribute__((target("pclmul,sse4.1")))
uint32_t crc32_pclmul_reg(const uint8_t* buf, size_t len, uint32_t crc0) {
  alignas(16) static const uint64_t k1k2[2] = {0x0154442bd4, 0x01c6e41596};
  alignas(16) static const uint64_t k3k4[2] = {0x01751997d0, 0x00ccaa009e};
  alignas(16) static const uint64_t k5k0[2] = {0x0163cd6124, 0x0000000000};
  alignas(16) static const uint64_t pmu[2] = {0x01db710641, 0x01f7011641};
  __m128i x0, x1, x2, x3, x4, x5, x6, x7, x8, y5, y6, y7, y8;
  x1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x00));
  x2 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x10));
  x3 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x20));
  x4 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x30));
  x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128(crc0));
  x0 = _mm_load_si128(reinterpret_cast<const __m128i*>(k1k2));
  buf += 64;
  len -= 64;
  while (len >= 64) {  // fold 4 lanes x 128 bits per iteration
    x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
    x6 = _mm_clmulepi64_si128(x2, x0, 0x00);
    x7 = _mm_clmulepi64_si128(x3, x0, 0x00);
    x8 = _mm_clmulepi64_si128(x4, x0, 0x00);
    x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
    x2 = _mm_clmulepi64_si128(x2, x0, 0x11);
    x3 = _mm_clmulepi64_si128(x3, x0, 0x11);
    x4 = _mm_clmulepi64_si128(x4, x0, 0x11);
    y5 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x00));
    y6 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x10));
    y7 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x20));
    y8 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 0x30));
    x1 = _mm_xor_si128(_mm_xor_si128(x1, x5), y5);
    x2 = _mm_xor_si128(_mm_xor_si128(x2, x6), y6);
    x3 = _mm_xor_si128(_mm_xor_si128(x3, x7), y7);
    x4 = _mm_xor_si128(_mm_xor_si128(x4, x8), y8);
    buf += 64;
    len -= 64;
  }
  x0 = _mm_load_si128(reinterpret_cast<const __m128i*>(k3k4));
  x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
  x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
  x1 = _mm_xor_si128(_mm_xor_si128(x1, x2), x5);
  x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
  x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
  x1 = _mm_xor_si128(_mm_xor_si128(x1, x3), x5);
  x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
  x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
  x1 = _mm_xor_si128(_mm_xor_si128(x1, x4), x5);
  while (len >= 16) {
    x2 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf));
    x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
    x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, x2), x5);
    buf += 16;
    len -= 16;
  }
  // 128 -> 64 bits.
  x2 = _mm_clmulepi64_si128(x1, x0, 0x10);
  x3 = _mm_setr_epi32(~0, 0, ~0, 0);
  x1 = _mm_srli_si128(x1, 8);
  x1 = _mm_xor_si128(x1, x2);
  x0 = _mm_loadl_epi64(reinterpret_cast<const __m128i*>(k5k0));
  x2 = _mm_srli_si128(x1, 4);
  x1 = _mm_and_si128(x1, x3);
  x1 = _mm_clmulepi64_si128(x1, x0, 0x00);
  x1 = _mm_xor_si128(x1, x2);
  // Barrett reduction to 32 bits.
  x0 = _mm_load_si128(reinterpret_cast<const __m128i*>(pmu));
  x2 = _mm_and_si128(x1, x3);
  x2 = _mm_clmulepi64_si128(x2, x0, 0x10);
  x2 = _mm_and_si128(x2, x3);
  x2 = _mm_clmulepi64_si128(x2, x0, 0x00);
  x1 = _mm_xor_si128(x1, x2);
  return static_cast<uint32_t>(_mm_extract_epi32(x1, 1));
}

bool cpu_has_pclmul() { return __builtin_cpu_supports("pclmul"); }
#else
bool cpu_has_pclmul() { return false; }
uint32_t crc32_pclmul_reg(const uint8_t*, size_t, uint32_t) { return 0; }
#endif

uint32_t crc32z(uint32_t crc, const uint8_t* p, size_t n) {
  std::call_once(crc_once, crc_init);
  static const bool pclmul = cpu_has_pclmul();
  if (pclmul && n >= 64) {
    // The folded kernel wants len % 16 == 0 and >= 64; the tail takes
    // the scalar path below.
    size_t chunk = n & ~static_cast<size_t>(15);
    crc = ~crc32_pclmul_reg(p, chunk, ~crc);
    p += chunk;
    n -= chunk;
    if (n == 0) return crc;
  }
  if (!zlib_crc32_ptr) return crc32_soft(crc, p, n);
  while (n > 0) {  // zlib's length parameter is 32-bit
    unsigned int chunk =
        n > 0x40000000u ? 0x40000000u : static_cast<unsigned int>(n);
    crc = static_cast<uint32_t>(zlib_crc32_ptr(crc, p, chunk));
    p += chunk;
    n -= chunk;
  }
  return crc;
}

inline uint64_t read64le(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t read32le(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

struct DecFrame {
  const uint8_t* head;     // frame start (crc covers head[0:22] + payload)
  const uint8_t* payload;
  uint64_t comp, orig;
  uint32_t crc;
  uint8_t flags, itemsize;
  bool has_crc;
  uint64_t dst_off;
};

// Error codes shared by decode/encode; |err_frame| reports the frame index.
constexpr long long PS_E_TRUNC = -1;   // frame runs past the source buffer
constexpr long long PS_E_MAGIC = -2;   // bad buffer-frame magic
constexpr long long PS_E_SIZE = -3;    // orig != caller-expected leaf bytes
constexpr long long PS_E_DST = -4;     // dst arena overflow
constexpr long long PS_E_CRC = -5;     // crc32 mismatch
constexpr long long PS_E_STORE = -6;   // store-mode payload != orig
constexpr long long PS_E_LZ = -7;      // corrupt LZ stream

long long decode_one(const DecFrame& f, uint8_t* dst,
                     std::vector<uint8_t>& scratch) {
  if (f.has_crc) {
    uint32_t c = crc32z(0, f.head, HDR_V1);
    c = crc32z(c, f.payload, f.comp);
    if (c != f.crc) return PS_E_CRC;
  }
  uint8_t* out = dst + f.dst_off;
  if (f.flags & FLAG_LZ) {
    if (f.flags & FLAG_SHUFFLE) {
      if (scratch.size() < f.orig) scratch.resize(f.orig);
      long long w = ps_lz_decompress(f.payload, f.comp, scratch.data(),
                                     f.orig);
      if (w != static_cast<long long>(f.orig)) return PS_E_LZ;
      ps_unshuffle(scratch.data(), out, f.orig, f.itemsize);
    } else {
      long long w = ps_lz_decompress(f.payload, f.comp, out, f.orig);
      if (w != static_cast<long long>(f.orig)) return PS_E_LZ;
    }
  } else {
    if (f.flags & FLAG_SHUFFLE) {
      ps_unshuffle(f.payload, out, f.orig, f.itemsize);
    } else {
      std::memcpy(out, f.payload, f.orig);
    }
  }
  return 0;
}

// Partition [0, n) into <= nthreads contiguous chunks balanced by weight.
std::vector<std::pair<size_t, size_t>> chunk_by_weight(
    const std::vector<uint64_t>& weight, int nthreads) {
  size_t n = weight.size();
  uint64_t total = 0;
  for (uint64_t w : weight) total += w;
  std::vector<std::pair<size_t, size_t>> chunks;
  uint64_t per = (total + nthreads - 1) / nthreads;
  if (per == 0) per = 1;
  size_t start = 0;
  uint64_t acc = 0;
  for (size_t i = 0; i < n; ++i) {
    acc += weight[i];
    if (acc >= per && i + 1 < n) {
      chunks.emplace_back(start, i + 1);
      start = i + 1;
      acc = 0;
    }
  }
  if (start < n) chunks.emplace_back(start, n);
  return chunks;
}

}  // namespace

extern "C" {

// zlib-compatible crc32 (exported so Python tests can assert parity).
uint32_t ps_crc32(uint32_t crc, const uint8_t* p, size_t n) {
  return crc32z(crc, p, n);
}

// Decode nframes buffer frames laid end-to-end at src into dst, frame i at
// dst_offsets[i] (caller-aligned), validating each frame's original size
// against expected_sizes[i] (from the tree metadata) and its crc32.
// Returns total decoded bytes, or a negative PS_E_* code with *err_frame =
// failing frame index.  Thread-parallel over frames when nthreads > 1.
long long ps_tree_decode(const uint8_t* src, size_t src_len,
                         const uint64_t* dst_offsets,
                         const uint64_t* expected_sizes, size_t nframes,
                         uint8_t* dst, size_t dst_cap, int nthreads,
                         long long* err_frame) {
  *err_frame = -1;
  std::vector<DecFrame> frames(nframes);
  std::vector<uint64_t> weight(nframes);
  size_t off = 0;
  uint64_t total = 0;
  for (size_t i = 0; i < nframes; ++i) {
    DecFrame& f = frames[i];
    if (src_len - off < 4) { *err_frame = i; return PS_E_TRUNC; }
    f.head = src + off;
    if (std::memcmp(f.head, "PSZ2", 4) == 0) {
      f.has_crc = true;
      if (src_len - off < HDR_V2) { *err_frame = i; return PS_E_TRUNC; }
    } else if (std::memcmp(f.head, "PSZ1", 4) == 0) {
      f.has_crc = false;
      if (src_len - off < HDR_V1) { *err_frame = i; return PS_E_TRUNC; }
    } else {
      *err_frame = i;
      return PS_E_MAGIC;
    }
    f.flags = f.head[4];
    f.itemsize = f.head[5];
    f.orig = read64le(f.head + 6);
    f.comp = read64le(f.head + 14);
    f.crc = f.has_crc ? read32le(f.head + 22) : 0;
    size_t hdr = f.has_crc ? HDR_V2 : HDR_V1;
    if (f.comp > src_len - off - hdr) { *err_frame = i; return PS_E_TRUNC; }
    f.payload = f.head + hdr;
    off += hdr + f.comp;
    if (f.orig != expected_sizes[i]) { *err_frame = i; return PS_E_SIZE; }
    if (!(f.flags & FLAG_LZ) && f.comp != f.orig) {
      *err_frame = i;
      return PS_E_STORE;
    }
    if (f.dst_off = dst_offsets[i]; f.dst_off > dst_cap ||
        f.orig > dst_cap - f.dst_off) {
      *err_frame = i;
      return PS_E_DST;
    }
    weight[i] = f.orig + f.comp;
    total += f.orig;
  }

  if (nthreads <= 1 || nframes < 2) {
    std::vector<uint8_t> scratch;
    for (size_t i = 0; i < nframes; ++i) {
      long long rc = decode_one(frames[i], dst, scratch);
      if (rc < 0) { *err_frame = static_cast<long long>(i); return rc; }
    }
    return static_cast<long long>(total);
  }

  auto chunks = chunk_by_weight(weight, nthreads);
  std::atomic<long long> err_code{0}, err_idx{-1};
  std::vector<std::thread> pool;
  pool.reserve(chunks.size());
  for (auto [lo, hi] : chunks) {
    pool.emplace_back([&, lo, hi] {
      std::vector<uint8_t> scratch;
      for (size_t i = lo; i < hi && err_code.load() == 0; ++i) {
        long long rc = decode_one(frames[i], dst, scratch);
        if (rc < 0) {
          long long expect = 0;
          if (err_code.compare_exchange_strong(expect, rc))
            err_idx.store(static_cast<long long>(i));
        }
      }
    });
  }
  for (auto& t : pool) t.join();
  if (err_code.load() < 0) {
    *err_frame = err_idx.load();
    return err_code.load();
  }
  return static_cast<long long>(total);
}

// Encode nframes raw buffers (src_ptrs[i], src_sizes[i] bytes, shuffle
// stride itemsizes[i]) as PSZ2 frames.  Frame i is built inside its
// worst-case region dst[region_offsets[i] .. +26+src_sizes[i]); after all
// frames land, a serial compaction pass packs them end-to-end from dst[0].
// frame_sizes[i] receives each frame's final byte count.  Returns total
// packed bytes or a negative PS_E_* code.  Byte-identical to the per-leaf
// Python compress() path (store fallback when LZ does not shrink).
long long ps_tree_encode(const uint64_t* src_ptrs, const uint64_t* src_sizes,
                         const uint8_t* itemsizes, size_t nframes, int level,
                         uint8_t* dst, size_t dst_cap,
                         const uint64_t* region_offsets, uint64_t* frame_sizes,
                         int nthreads, long long* err_frame) {
  *err_frame = -1;
  for (size_t i = 0; i < nframes; ++i) {  // bounds up front, threads after
    if (region_offsets[i] > dst_cap ||
        HDR_V2 + src_sizes[i] > dst_cap - region_offsets[i]) {
      *err_frame = static_cast<long long>(i);
      return PS_E_DST;
    }
  }

  auto encode_one = [&](size_t i, std::vector<uint8_t>& sh_scratch,
                        std::vector<uint8_t>& lz_scratch) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(
        static_cast<uintptr_t>(src_ptrs[i]));
    uint64_t n = src_sizes[i];
    uint8_t itemsize = itemsizes[i];
    uint8_t flags = 0;
    const uint8_t* work = src;
    if (level >= 1 && itemsize > 1 && n > 0 && n % itemsize == 0) {
      if (sh_scratch.size() < n) sh_scratch.resize(n);
      ps_shuffle(src, sh_scratch.data(), n, itemsize);
      work = sh_scratch.data();
      flags |= FLAG_SHUFFLE;
    }
    const uint8_t* payload = work;
    uint64_t plen = n;
    if (level >= 1 && n > 0) {
      size_t cap = ps_max_compressed(n);
      if (lz_scratch.size() < cap) lz_scratch.resize(cap);
      long long csize = ps_lz_compress(work, n, lz_scratch.data(), cap);
      if (csize > 0 && static_cast<uint64_t>(csize) < n) {
        flags |= FLAG_LZ;
        payload = lz_scratch.data();
        plen = static_cast<uint64_t>(csize);
      }
    }
    uint8_t* f = dst + region_offsets[i];
    std::memcpy(f, "PSZ2", 4);
    f[4] = flags;
    f[5] = itemsize;
    std::memcpy(f + 6, &n, 8);
    std::memcpy(f + 14, &plen, 8);
    uint32_t crc = crc32z(0, f, HDR_V1);
    crc = crc32z(crc, payload, plen);
    std::memcpy(f + 22, &crc, 4);
    std::memcpy(f + HDR_V2, payload, plen);
    frame_sizes[i] = HDR_V2 + plen;
  };

  if (nthreads <= 1 || nframes < 2) {
    std::vector<uint8_t> sh, lz;
    for (size_t i = 0; i < nframes; ++i) encode_one(i, sh, lz);
  } else {
    std::vector<uint64_t> weight(src_sizes, src_sizes + nframes);
    auto chunks = chunk_by_weight(weight, nthreads);
    std::vector<std::thread> pool;
    pool.reserve(chunks.size());
    for (auto [lo, hi] : chunks) {
      pool.emplace_back([&, lo, hi] {
        std::vector<uint8_t> sh, lz;
        for (size_t i = lo; i < hi; ++i) encode_one(i, sh, lz);
      });
    }
    for (auto& t : pool) t.join();
  }

  // Compact frames end-to-end (regions were worst-case sized; moves are
  // always leftward so memmove in index order is safe).
  uint64_t pos = 0;
  for (size_t i = 0; i < nframes; ++i) {
    if (pos != region_offsets[i])
      std::memmove(dst + pos, dst + region_offsets[i], frame_sizes[i]);
    pos += frame_sizes[i];
  }
  return static_cast<long long>(pos);
}

}  // extern "C"
