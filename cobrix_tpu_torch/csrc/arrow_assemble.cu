// Arrow buffers from decoded planes, for Hopper (sm_90a).
//
// Replaces host C++ of the JAX package, not a TPU kernel: the Arrow legs
// of native.assemble_cols_arrow (cobrix_tpu/native/columnar.cpp:518, the
// value buffers and the decimal128 build of write_decimal128, :206-231,
// with its row masks, :508-516), pack_validity (columnar.cpp:740),
// transcode_string_cols_arrow (cobrix_tpu/native/framing.cpp:600, UTF-8
// sizes as at :584-596), decimal128_from_limbs (framing.cpp:973) and
// decimal128_batch (framing.cpp:1034). The JAX package decodes the raw
// bytes again there; the port's planes were decoded on the card already
// (the fused kernel, the string and float ops), so these kernels read the
// planes of one batch, uploaded in one copy, and write every Arrow buffer
// of the batch into one output buffer that goes back in one copy.
//
// One descriptor row a requested output array (ops/arrow_assemble.py
// builds the table; its plain version computes the same bytes):
// element j of an array of S slots is slot j % S of row j / S, or of row
// rows[j / S] with a row table; a row a visibility mask hides is null and
// zero (strings: blank) and its planes are not read. Outputs:
//   arrow_scalars: int32 / int64 / float32 / float64 / decimal128 values,
//     zero under a null, validity words of 32 bits (a warp's ballot), the
//     null count, and a bad flag when a decimal leaves the exact window
//     (the caller then builds that column from its Python values);
//   arrow_str_lengths: each string's trimmed extent and UTF-8 length
//     (1-3 bytes a code point), a tile's sum, a bad flag on a surrogate;
//   arrow_str_offsets: a block a string array scans its tiles' sums into
//     tile bases and the array's total (bad past 2^31 - 1); the last
//     block to finish scans the totals into each array's data start;
//   arrow_str_copy: a tile's block scan of the lengths gives the int32
//     offsets, and each thread writes its string's UTF-8 bytes.
//
// What bounds them on this card: bytes, read and written once at 3.35
// TB/s (planes in, Arrow buffers out). The design is the simple one: a
// thread an element, no staging, no TMA; a flat OCCURS array reads its
// slots' planes S rows apart (a sector a value), and a string thread
// walks its value's code points alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// descriptor fields (ops/arrow_assemble.py)
constexpr int D_LEN = 0, D_SLOTS = 1, D_SLOT_TAB = 2, D_ROWS = 3,
              D_MASK = 4, D_SRC = 5, D_STRIDE = 6, D_OUT = 7, D_DEC = 8,
              D_SHIFT = 9, D_MAXD = 10, D_VALUES = 11, D_BITMAP = 12,
              D_WIDTH = 13, D_TRIM = 14, D_NF = 15;
// slot table fields: byte offsets in the source of each plane
constexpr int S_VALUES = 0, S_VALID = 1, S_HI = 2, S_NEG = 3, S_DOTS = 4,
              S_NF = 5;
// counters a request: null count, bad, data start, total
constexpr int C_NULLS = 0, C_BAD = 1, C_START = 2, C_TOTAL = 3, C_NF = 4;

enum Src { SRC_I32 = 0, SRC_I64 = 1, SRC_F32 = 2, SRC_F64 = 3, SRC_WIDE = 4,
           SRC_CP8 = 5, SRC_CP16 = 6 };
enum Out { OUT_I32 = 0, OUT_I64 = 1, OUT_F32 = 2, OUT_F64 = 3,
           OUT_DEC = 4, OUT_UTF8 = 5 };
enum Dec { DEC_NONE = 0, DEC_STATIC = 1, DEC_DOTS = 2, DEC_DIGITS = 3 };
enum Trim { TRIM_NONE = 0, TRIM_BOTH = 1, TRIM_LEFT = 2, TRIM_RIGHT = 3 };

constexpr int kTile = 256;        // elements a block (a thread each)
constexpr int kScanThreads = 1024;

struct U128 {
  uint64_t hi, lo;
};

// 10^k, k = 0..38
__constant__ U128 kPow10[39] = {
    {0x0ull, 0x1ull},
    {0x0ull, 0xaull},
    {0x0ull, 0x64ull},
    {0x0ull, 0x3e8ull},
    {0x0ull, 0x2710ull},
    {0x0ull, 0x186a0ull},
    {0x0ull, 0xf4240ull},
    {0x0ull, 0x989680ull},
    {0x0ull, 0x5f5e100ull},
    {0x0ull, 0x3b9aca00ull},
    {0x0ull, 0x2540be400ull},
    {0x0ull, 0x174876e800ull},
    {0x0ull, 0xe8d4a51000ull},
    {0x0ull, 0x9184e72a000ull},
    {0x0ull, 0x5af3107a4000ull},
    {0x0ull, 0x38d7ea4c68000ull},
    {0x0ull, 0x2386f26fc10000ull},
    {0x0ull, 0x16345785d8a0000ull},
    {0x0ull, 0xde0b6b3a7640000ull},
    {0x0ull, 0x8ac7230489e80000ull},
    {0x5ull, 0x6bc75e2d63100000ull},
    {0x36ull, 0x35c9adc5dea00000ull},
    {0x21eull, 0x19e0c9bab2400000ull},
    {0x152dull, 0x2c7e14af6800000ull},
    {0xd3c2ull, 0x1bcecceda1000000ull},
    {0x84595ull, 0x161401484a000000ull},
    {0x52b7d2ull, 0xdcc80cd2e4000000ull},
    {0x33b2e3cull, 0x9fd0803ce8000000ull},
    {0x204fce5eull, 0x3e25026110000000ull},
    {0x1431e0faeull, 0x6d7217caa0000000ull},
    {0xc9f2c9cd0ull, 0x4674edea40000000ull},
    {0x7e37be2022ull, 0xc0914b2680000000ull},
    {0x4ee2d6d415bull, 0x85acef8100000000ull},
    {0x314dc6448d93ull, 0x38c15b0a00000000ull},
    {0x1ed09bead87c0ull, 0x378d8e6400000000ull},
    {0x13426172c74d82ull, 0x2b878fe800000000ull},
    {0xc097ce7bc90715ull, 0xb34b9f1000000000ull},
    {0x785ee10d5da46d9ull, 0xf436a000000000ull},
    {0x4b3b4ca85a86c47aull, 0x98a224000000000ull}};

__device__ __forceinline__ bool ge128(U128 a, U128 b) {
  return a.hi > b.hi || (a.hi == b.hi && a.lo >= b.lo);
}

// decimal digit count of the magnitude (1 for 0), at most 39
__device__ int digit_count(U128 m) {
  int nd = 1;
  while (nd < 39 && ge128(m, kPow10[nd])) ++nd;
  return nd;
}

// m * 10^k mod 2^128 and whether the product leaves 128 bits
__device__ U128 mul_pow10(U128 m, int k, bool* over) {
  const U128 p = kPow10[k];
  const uint64_t p1_lo = m.lo * p.lo, p1_hi = __umul64hi(m.lo, p.lo);
  const uint64_t p2_lo = m.lo * p.hi, p2_hi = __umul64hi(m.lo, p.hi);
  const uint64_t p3_lo = m.hi * p.lo, p3_hi = __umul64hi(m.hi, p.lo);
  const uint64_t s1 = p1_hi + p2_lo;
  const uint64_t hi = s1 + p3_lo;
  *over = (m.hi != 0 && p.hi != 0) || p2_hi != 0 || p3_hi != 0 ||
          s1 < p1_hi || hi < s1;
  return U128{hi, p1_lo};
}

template <typename T>
__device__ __forceinline__ T load(const uint8_t* base, int64_t off) {
  return *reinterpret_cast<const T*>(base + off);
}

struct Req {
  const int64_t* d;
  __device__ int64_t operator[](int f) const { return d[f]; }
};

// the request of work tile `tile`: starts[m] <= tile < starts[m + 1]
__device__ __forceinline__ int64_t find_request(const int64_t* starts,
                                                int64_t nreq, int64_t tile) {
  int64_t lo = 0, hi = nreq - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int64_t row_of(const uint8_t* aux, Req r,
                                          int64_t j) {
  const int64_t slots = r[D_SLOTS];
  const int64_t k = j / slots;
  return r[D_ROWS] >= 0 ? load<int64_t>(aux, r[D_ROWS] + 8 * k) : k;
}

__device__ __forceinline__ bool hidden(const uint8_t* aux, Req r,
                                       int64_t row) {
  return r[D_MASK] >= 0 && aux[r[D_MASK] + row] == 0;
}

// ---------------------------------------------------------------------------
// scalars
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTile) arrow_scalars(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ aux,
    const int64_t* __restrict__ desc, const int64_t* __restrict__ ids,
    const int64_t* __restrict__ starts, int64_t nreq,
    uint8_t* __restrict__ out) {
  const int64_t tile = blockIdx.x;
  const int64_t m = find_request(starts, nreq, tile);
  const int64_t id = ids[m];
  const Req r{desc + id * D_NF};
  const int64_t L = r[D_LEN];
  const int64_t j = (tile - starts[m]) * kTile + threadIdx.x;
  const bool in = j < L;
  bool valid = false, bad = false;
  int64_t v64 = 0;          // int and float outputs: the bits to store
  U128 dec{0, 0};
  const int out_kind = static_cast<int>(r[D_OUT]);
  if (in) {
    const int64_t row = row_of(aux, r, j);
    if (!hidden(aux, r, row)) {
      const int64_t s = j % r[D_SLOTS];
      const int64_t* slot = reinterpret_cast<const int64_t*>(
          aux + r[D_SLOT_TAB]) + s * S_NF;
      const int64_t stride = r[D_STRIDE];
      const int src_kind = static_cast<int>(r[D_SRC]);
      valid = src[slot[S_VALID] + row * stride] != 0;
      int64_t iv = 0;       // integer planes' value
      uint64_t bits = 0;    // float planes' bits
      U128 mag{0, 0};
      bool neg = false;
      switch (src_kind) {
        case SRC_I32: iv = load<int32_t>(src, slot[S_VALUES] + row * stride * 4); break;
        case SRC_I64: iv = load<int64_t>(src, slot[S_VALUES] + row * stride * 8); break;
        case SRC_F32: bits = load<uint32_t>(src, slot[S_VALUES] + row * stride * 4); break;
        case SRC_F64: bits = load<uint64_t>(src, slot[S_VALUES] + row * stride * 8); break;
        case SRC_WIDE:
          mag.lo = load<uint64_t>(src, slot[S_VALUES] + row * stride * 8);
          mag.hi = load<uint64_t>(src, slot[S_HI] + row * stride * 8);
          neg = src[slot[S_NEG] + row * stride] != 0;
          break;
        default: break;
      }
      if (src_kind == SRC_I32 || src_kind == SRC_I64) {
        neg = iv < 0;
        // |INT64_MIN| wraps to itself: its unsigned view is 2^63
        mag.lo = neg ? 0ull - static_cast<uint64_t>(iv)
                     : static_cast<uint64_t>(iv);
      }
      switch (out_kind) {
        case OUT_I32: case OUT_I64: v64 = iv; break;
        case OUT_F32:
          v64 = src_kind == SRC_F32 ? bits
              : __float_as_uint(static_cast<float>(__longlong_as_double(
                    static_cast<long long>(bits))));
          break;
        case OUT_F64:
          v64 = src_kind == SRC_F64 ? static_cast<int64_t>(bits)
              : __double_as_longlong(static_cast<double>(
                    __uint_as_float(static_cast<uint32_t>(bits))));
          break;
        case OUT_DEC: {
          int64_t shift = r[D_SHIFT];
          if (r[D_DEC] == DEC_DOTS) {
            shift -= load<int32_t>(src, slot[S_DOTS] + row * stride * 4);
          } else if (r[D_DEC] == DEC_DIGITS) {
            // the int64 plane's digit count tops out at 19
            shift -= digit_count(mag);
          }
          const int64_t maxd = r[D_MAXD];
          if (maxd == 0) {
            // mantissas of up to 18 digits: every visible row's shift
            // in 0..18, the product unbounded (it fits 128 bits)
            if (shift < 0 || shift > 18) {
              bad = true;
            } else if (valid) {
              bool over;
              dec = mul_pow10(mag, static_cast<int>(shift), &over);
            }
          } else if (valid) {
            // bounded by the declared precision, valid rows only
            if (shift < 0 || shift > 38) {
              bad = true;
            } else {
              bool over;
              dec = mul_pow10(mag, static_cast<int>(shift), &over);
              if (over || ge128(dec, kPow10[maxd])) bad = true;
            }
            if (bad) dec = U128{0, 0};
          }
          if (neg && valid) {
            // two's complement of the 128-bit magnitude
            const uint64_t lo = ~dec.lo + 1;
            dec.hi = ~dec.hi + (lo == 0 ? 1 : 0);
            dec.lo = lo;
          }
          break;
        }
        default: break;
      }
      if (!valid) { v64 = 0; dec = U128{0, 0}; }
    }
  }
  uint8_t* values = out + r[D_VALUES];
  if (in) {
    switch (out_kind) {
      case OUT_I32: case OUT_F32:
        reinterpret_cast<uint32_t*>(values)[j] = static_cast<uint32_t>(v64);
        break;
      case OUT_I64: case OUT_F64:
        reinterpret_cast<int64_t*>(values)[j] = v64;
        break;
      case OUT_DEC:
        reinterpret_cast<uint64_t*>(values)[2 * j] = dec.lo;
        reinterpret_cast<uint64_t*>(values)[2 * j + 1] = dec.hi;
        break;
      default: break;
    }
  }
  const unsigned word = __ballot_sync(0xffffffffu, in && valid);
  const int lane = threadIdx.x & 31;
  const int64_t first = j - lane;
  if (lane == 0 && first < L) {
    reinterpret_cast<uint32_t*>(out + r[D_BITMAP])[first >> 5] = word;
  }
  __shared__ int nulls[kTile / 32];
  __shared__ int any_bad;
  if (threadIdx.x == 0) any_bad = 0;
  const unsigned missing = __ballot_sync(0xffffffffu, in && !valid);
  if (lane == 0) nulls[threadIdx.x >> 5] = __popc(missing);
  __syncthreads();
  if (bad) any_bad = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kTile / 32; ++w) total += nulls[w];
    int64_t* counters = reinterpret_cast<int64_t*>(out) + id * C_NF;
    if (total) {
      atomicAdd(reinterpret_cast<unsigned long long*>(counters + C_NULLS),
                static_cast<unsigned long long>(total));
    }
    if (any_bad) counters[C_BAD] = 1;
  }
}

// ---------------------------------------------------------------------------
// strings
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t code_point(const uint8_t* p, int wide,
                                               int64_t k) {
  return wide ? load<uint16_t>(p, 2 * k) : p[k];
}

__device__ __forceinline__ bool trims(uint32_t c, int mode) {
  return mode == TRIM_BOTH ? c <= 0x20 : (c == 0x20 || c == 0x09);
}

__device__ __forceinline__ int utf8_len(uint32_t c) {
  return c < 0x80 ? 1 : c < 0x800 ? 2 : 3;
}

// the value of element j: its code points (null: blank) and trimmed extent
struct Value {
  const uint8_t* p;   // null for a hidden row: every code point is 0x20
  int wide;
  int64_t s, e;
};

__device__ Value value_of(const uint8_t* src, const uint8_t* aux, Req r,
                          int64_t j) {
  const int64_t row = row_of(aux, r, j);
  const int64_t w = r[D_WIDTH];
  const int wide = r[D_SRC] == SRC_CP16;
  Value v{nullptr, wide, 0, w};
  const int mode = static_cast<int>(r[D_TRIM]);
  if (hidden(aux, r, row)) {
    if (mode != TRIM_NONE) v.e = 0;   // blanks trim away
    return v;
  }
  const int64_t* slot = reinterpret_cast<const int64_t*>(aux + r[D_SLOT_TAB]);
  v.p = src + slot[S_VALUES] + row * r[D_STRIDE] * (wide ? 2 : 1);
  if (mode == TRIM_BOTH || mode == TRIM_LEFT) {
    while (v.s < v.e && trims(code_point(v.p, wide, v.s), mode)) ++v.s;
  }
  if (mode == TRIM_BOTH || mode == TRIM_RIGHT) {
    while (v.e > v.s && trims(code_point(v.p, wide, v.e - 1), mode)) --v.e;
  }
  return v;
}

template <typename T>
__device__ T block_sum(T x, T* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (lane == 0) shared[warp] = x;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) total += shared[w];
  }
  return total;   // thread 0's
}

// inclusive scan over the block; `shared` holds a value a warp
template <typename T>
__device__ T block_scan(T x, T* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) shared[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int warps = (blockDim.x + 31) / 32;
    T s = lane < warps ? shared[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < warps) shared[lane] = s;
  }
  __syncthreads();
  if (warp > 0) x += shared[warp - 1];
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(kTile) arrow_str_lengths(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ aux,
    const int64_t* __restrict__ desc, const int64_t* __restrict__ ids,
    const int64_t* __restrict__ starts, int64_t nreq,
    uint8_t* __restrict__ out, int64_t* __restrict__ tile_sums) {
  const int64_t tile = blockIdx.x;
  const int64_t m = find_request(starts, nreq, tile);
  const int64_t id = ids[m];
  const Req r{desc + id * D_NF};
  const int64_t j = (tile - starts[m]) * kTile + threadIdx.x;
  int32_t* offsets = reinterpret_cast<int32_t*>(out + r[D_VALUES]);
  int64_t len = 0;
  bool bad = false;
  if (j < r[D_LEN]) {
    const Value v = value_of(src, aux, r, j);
    for (int64_t k = v.s; k < v.e; ++k) {
      const uint32_t c = v.p ? code_point(v.p, v.wide, k) : 0x20;
      len += utf8_len(c);
      bad |= (c >= 0xD800 && c <= 0xDFFF);
    }
    offsets[j + 1] = static_cast<int32_t>(len);
    if (j == 0) offsets[0] = 0;
  }
  __shared__ int64_t part[kTile / 32];
  const int64_t sum = block_sum<int64_t>(len, part);
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    tile_sums[tile] = sum;
    if (any_bad) reinterpret_cast<int64_t*>(out)[id * C_NF + C_BAD] = 1;
  }
}

// a block a string request: its tiles' sums -> exclusive tile bases, the
// request's total; the last block to finish scans the totals into each
// request's data start and the grand total
__global__ void __launch_bounds__(kScanThreads) arrow_str_offsets(
    const int64_t* __restrict__ ids, const int64_t* __restrict__ starts,
    int64_t nreq, uint8_t* __restrict__ out, int64_t* __restrict__ tile_sums,
    unsigned int* __restrict__ done, int64_t grand_slot) {
  __shared__ int64_t part[kScanThreads / 32];
  __shared__ int64_t chunk;
  __shared__ int last;
  int64_t* counters = reinterpret_cast<int64_t*>(out);
  const int64_t m = blockIdx.x;
  const int64_t t0 = starts[m], t1 = starts[m + 1];
  int64_t carry = 0;
  for (int64_t base = t0; base < t1; base += kScanThreads) {
    const int64_t t = base + threadIdx.x;
    const int64_t x = t < t1 ? tile_sums[t] : 0;
    const int64_t inc = block_scan<int64_t>(x, part);
    if (t < t1) tile_sums[t] = carry + inc - x;
    if (threadIdx.x == kScanThreads - 1) chunk = inc;
    __syncthreads();
    carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int64_t* c = counters + ids[m] * C_NF;
    if (carry > 2147483647LL) c[C_BAD] = 1;
    // a request whose column the caller rebuilds reserves no data
    c[C_TOTAL] = c[C_BAD] ? 0 : carry;
    __threadfence();
    last = atomicAdd(done, 1u) == static_cast<unsigned>(nreq - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  carry = 0;
  for (int64_t base = 0; base < nreq; base += kScanThreads) {
    const int64_t k = base + threadIdx.x;
    const int64_t x = k < nreq
        ? *reinterpret_cast<volatile int64_t*>(counters + ids[k] * C_NF
                                               + C_TOTAL)
        : 0;
    const int64_t inc = block_scan<int64_t>(x, part);
    if (k < nreq) counters[ids[k] * C_NF + C_START] = carry + inc - x;
    if (threadIdx.x == kScanThreads - 1) chunk = inc;
    __syncthreads();
    carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) counters[grand_slot] = carry;
}

__global__ void __launch_bounds__(kTile) arrow_str_copy(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ aux,
    const int64_t* __restrict__ desc, const int64_t* __restrict__ ids,
    const int64_t* __restrict__ starts, int64_t nreq,
    uint8_t* __restrict__ out, const int64_t* __restrict__ tile_sums,
    int64_t data_off) {
  const int64_t tile = blockIdx.x;
  const int64_t m = find_request(starts, nreq, tile);
  const int64_t id = ids[m];
  const Req r{desc + id * D_NF};
  const int64_t* c = reinterpret_cast<const int64_t*>(out) + id * C_NF;
  if (c[C_BAD]) return;   // the caller rebuilds this column
  const int64_t j = (tile - starts[m]) * kTile + threadIdx.x;
  const bool in = j < r[D_LEN];
  int32_t* offsets = reinterpret_cast<int32_t*>(out + r[D_VALUES]);
  const int32_t len = in ? offsets[j + 1] : 0;
  __shared__ int32_t part[kTile / 32];
  const int32_t inc = block_scan<int32_t>(len, part);
  const int64_t base = tile_sums[tile];
  if (!in) return;
  offsets[j + 1] = static_cast<int32_t>(base + inc);
  uint8_t* dst = out + data_off + c[C_START] + base + (inc - len);
  const Value v = value_of(src, aux, r, j);
  for (int64_t k = v.s; k < v.e; ++k) {
    const uint32_t u = v.p ? code_point(v.p, v.wide, k) : 0x20;
    if (u < 0x80) {
      *dst++ = static_cast<uint8_t>(u);
    } else if (u < 0x800) {
      *dst++ = static_cast<uint8_t>(0xC0 | (u >> 6));
      *dst++ = static_cast<uint8_t>(0x80 | (u & 0x3F));
    } else {
      *dst++ = static_cast<uint8_t>(0xE0 | (u >> 12));
      *dst++ = static_cast<uint8_t>(0x80 | ((u >> 6) & 0x3F));
      *dst++ = static_cast<uint8_t>(0x80 | (u & 0x3F));
    }
  }
}

}  // namespace

// Every entry launches on `stream` and returns the CUDA error (0 = none).
// `tiles` is the number of work tiles of its class (starts[nreq]).

extern "C" int cobrix_arrow_scalars(const void* src, const void* aux,
                                    const void* desc, const void* ids,
                                    const void* starts, int64_t nreq,
                                    int64_t tiles, void* out, void* stream) {
  if (tiles == 0) return 0;
  arrow_scalars<<<static_cast<unsigned>(tiles), kTile, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(aux),
      static_cast<const int64_t*>(desc), static_cast<const int64_t*>(ids),
      static_cast<const int64_t*>(starts), nreq, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cobrix_arrow_str_lengths(const void* src, const void* aux,
                                        const void* desc, const void* ids,
                                        const void* starts, int64_t nreq,
                                        int64_t tiles, void* out,
                                        void* tile_sums, void* stream) {
  if (tiles == 0) return 0;
  arrow_str_lengths<<<static_cast<unsigned>(tiles), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(aux),
      static_cast<const int64_t*>(desc), static_cast<const int64_t*>(ids),
      static_cast<const int64_t*>(starts), nreq, static_cast<uint8_t*>(out),
      static_cast<int64_t*>(tile_sums));
  return static_cast<int>(cudaGetLastError());
}

// `done` is a zeroed uint32 on the device; counters[grand_slot] (int64
// words of `out`) receives the sum of the data starts' totals
extern "C" int cobrix_arrow_str_offsets(const void* ids,
                                        const void* starts, int64_t nreq,
                                        void* out, void* tile_sums,
                                        void* done, int64_t grand_slot,
                                        void* stream) {
  if (nreq == 0) return 0;
  arrow_str_offsets<<<static_cast<unsigned>(nreq), kScanThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), static_cast<const int64_t*>(starts),
      nreq, static_cast<uint8_t*>(out), static_cast<int64_t*>(tile_sums),
      static_cast<unsigned int*>(done),
      grand_slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cobrix_arrow_str_copy(const void* src, const void* aux,
                                     const void* desc, const void* ids,
                                     const void* starts, int64_t nreq,
                                     int64_t tiles, void* out,
                                     const void* tile_sums, int64_t data_off,
                                     void* stream) {
  if (tiles == 0) return 0;
  arrow_str_copy<<<static_cast<unsigned>(tiles), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(aux),
      static_cast<const int64_t*>(desc), static_cast<const int64_t*>(ids),
      static_cast<const int64_t*>(starts), nreq, static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(tile_sums), data_off);
  return static_cast<int>(cudaGetLastError());
}
