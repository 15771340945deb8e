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
// builds the table; its plain version computes the same bytes). Element
// j of an array of S slots is slot j % S of row j / S, or of row
// rows[j / S] with a row table; a row a visibility mask hides is null and
// zero (strings: blank) and its values are not used. A plane kind p (the
// values, valid flags, high limbs, signs, dot counts) is laid out evenly
// over the slots: slot s's plane starts base[p] + s * step[p] bytes into
// the source, and its rows are `rstride` elements apart. Outputs:
//   arrow_scalars: int32 / int64 / float32 / float64 / decimal128 values,
//     zero under a null, validity words of 32 bits, the null count, and a
//     bad flag when a decimal leaves the exact window (the caller then
//     builds that column from its Python values);
//   arrow_str_lengths: each string's trimmed extent and UTF-8 length
//     (1-3 bytes a code point), a tile's sum, a bad flag on a surrogate,
//     and, by a look-back over the tiles of each array, the tiles' bases,
//     the array's total (bad past 2^31 - 1) and, in the last tile to
//     finish, each array's data start;
//   arrow_str_copy: a tile's block scan of the lengths gives the int32
//     offsets, and the tile's UTF-8 bytes are written as one range.
//
// What bounds them on this card: bytes, read and written once at 3.35
// TB/s (planes in, Arrow buffers out), and, at the small shapes of one
// batch, the latency of the chain of loads a block waits on before its
// first value, and of each launch. The kernels are built for both (their
// notes below): a block loads its work entry and its descriptor once,
// stages its tile of planes in shared memory with 16-byte loads, and
// writes whole words and sectors; a string batch takes two launches,
// lengths with their scan, then the copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// descriptor fields (ops/arrow_assemble.py): the plane table is
// D_BASE + p and D_STEP + p for plane kind p
constexpr int D_LEN = 0, D_SLOTS = 1, D_ROWS = 2, D_MASK = 3, D_SRC = 4,
              D_RSTRIDE = 5, D_OUT = 6, D_DEC = 7, D_SHIFT = 8, D_MAXD = 9,
              D_VALUES = 10, D_BITMAP = 11, D_WIDTH = 12, D_TRIM = 13,
              D_RT = 14, D_SC = 15, D_RTILES = 16, D_BASE = 17, D_STEP = 22,
              D_NF = 27;
// plane kinds
constexpr int P_VALUES = 0, P_VALID = 1, P_HI = 2, P_NEG = 3, P_DOTS = 4;
// counters a request: null count, bad, data start, total
constexpr int C_NULLS = 0, C_BAD = 1, C_START = 2, C_TOTAL = 3, C_NF = 4;

enum Src { SRC_I32 = 0, SRC_I64 = 1, SRC_F32 = 2, SRC_F64 = 3, SRC_WIDE = 4,
           SRC_CP8 = 5, SRC_CP16 = 6 };
enum Out { OUT_I32 = 0, OUT_I64 = 1, OUT_F32 = 2, OUT_F64 = 3,
           OUT_DEC = 4, OUT_UTF8 = 5 };
enum Dec { DEC_NONE = 0, DEC_STATIC = 1, DEC_DOTS = 2, DEC_DIGITS = 3 };
enum Trim { TRIM_NONE = 0, TRIM_BOTH = 1, TRIM_LEFT = 2, TRIM_RIGHT = 3 };

constexpr int kTile = 256;        // threads a block; strings a string tile
constexpr int kRows = 2048;       // rows a scalar tile at most (RT)
constexpr int kElems = 4096;      // elements a scalar tile at most (RT x SC)
constexpr int kCap = 4128;        // staged slots a scalar tile, SC x (RT + 1)
constexpr int kStrCp = 16384;     // staged code-point bytes of a string tile
constexpr int kStrOut = 24576;    // staged UTF-8 bytes of a string tile

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

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename T>
__device__ __forceinline__ T load(const uint8_t* base, int64_t off) {
  return *reinterpret_cast<const T*>(base + off);
}

// byte offset in the source of plane kind p's element at (row, slot s);
// `item`: the plane's element bytes
__device__ __forceinline__ int64_t plane_at(const int64_t* d, int p,
                                            int64_t row, int64_t s,
                                            int item) {
  return d[D_BASE + p] + s * d[D_STEP + p] + row * d[D_RSTRIDE] * item;
}

// the element at byte b of the 16-byte word w, stored at dst + x
template <int kItem>
__device__ __forceinline__ void put(uint8_t* dst, int64_t x,
                                    const uint32_t (&w)[4], int b) {
  if (kItem == 1) {
    dst[x] = static_cast<uint8_t>(w[b >> 2] >> (8 * (b & 3)));
  } else if (kItem == 2) {
    *reinterpret_cast<uint16_t*>(dst + x) =
        static_cast<uint16_t>(w[b >> 2] >> (8 * (b & 3)));
  } else if (kItem == 4) {
    *reinterpret_cast<uint32_t*>(dst + x) = w[b >> 2];
  } else {
    *reinterpret_cast<uint2*>(dst + x) = make_uint2(w[b >> 2],
                                                    w[(b >> 2) + 1]);
  }
}

// the aligned 16-byte word at byte g of `src` (16-byte aligned); a word
// that runs past `src_bytes` is read a byte at a time
__device__ __forceinline__ uint4 load_word(const uint8_t* __restrict__ src,
                                           int64_t src_bytes, int64_t g) {
  if (g + 16 <= src_bytes) {
    return __ldg(reinterpret_cast<const uint4*>(src + g));
  }
  uint32_t w[4] = {0, 0, 0, 0};
  for (int b = 0; b < 16; ++b) {
    if (g + b < src_bytes) {
      w[b >> 2] |= static_cast<uint32_t>(src[g + b]) << (8 * (b & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the bytes of word v that fall in dst[0, nb), v's byte 0 at dst + x0
template <int kItem>
__device__ __forceinline__ void put_word(uint8_t* dst, int x0, int nb,
                                         const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (x0 >= 0 && x0 + 16 <= nb) {
#pragma unroll
    for (int b = 0; b < 16; b += kItem) put<kItem>(dst, x0 + b, w, b);
  } else {
#pragma unroll
    for (int b = 0; b < 16; b += kItem) {
      if (static_cast<unsigned>(x0 + b) < static_cast<unsigned>(nb)) {
        put<kItem>(dst, x0 + b, w, b);
      }
    }
  }
}

// runs r = 0 .. nruns - 1 of nb bytes, run r from byte start(r) of `src`
// (negative: no run) into dst + r * dst_stride, as the aligned 16-byte
// words each run touches. A thread takes kBatch words at a time and
// issues their loads before any of their stores (the string copy, whose
// block waits on little else, keeps four in flight; the string lengths
// two and the scalar kernel one, as more registers would cost them
// blocks an SM). start(r) and nb are multiples of kItem.
template <int kItem, int kBatch, typename Start>
__device__ __forceinline__ void stage_runs(uint8_t* dst, int dst_stride,
                                           const uint8_t* __restrict__ src,
                                           int64_t src_bytes, int nruns,
                                           int nb, Start start) {
  const int per = nb / 16 + 2;   // words a run touches, at most
  const int total = nruns * per;
  for (int q0 = threadIdx.x; q0 < total; q0 += kBatch * kTile) {
    uint4 v[kBatch];
    int run[kBatch], x0[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kTile;
      run[u] = -1;
      if (q < total) {
        const int r = q / per;
        const int64_t a0 = start(r);
        const int64_t g = (a0 & ~int64_t(15)) + 16 * (q - r * per);
        if (a0 >= 0 && g < a0 + nb) {
          run[u] = r;
          x0[u] = static_cast<int>(g - a0);   // -15 .. nb - 1
          v[u] = load_word(src, src_bytes, g);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (run[u] >= 0) put_word<kItem>(dst + run[u] * dst_stride, x0[u], nb,
                                       v[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// scalars
// ---------------------------------------------------------------------------
//
// What bounds it: bytes (each visible element's value and valid flag in,
// its value and validity bit out, 3.35 TB/s), and at one batch's shapes
// the chain of dependent loads before a block's first value: the simple
// design's 256-element blocks each searched the request starts, read the
// descriptor field by field from global memory, then the row table, the
// mask and a slot table before the planes, and a flat OCCURS array's
// neighbouring elements were slots n rows apart, a 32-byte sector for
// each 4-byte value and each 1-byte flag.
//
// The design. A block takes one tile of one request: RT rows x SC slots
// (ops/arrow_assemble.py `scalar_tile`: 2,048 rows of a one-slot array,
// whole rows of up to 64 slots, 128 rows x 32 slots of a wider one), named
// by its entry (request, tile) of the work table the plan builds; there
// is no search. One warp copies the descriptor into shared memory and
// every thread reads it there. The tile's values and valid flags are
// staged in shared memory column by column (a column: one slot's RT
// rows). Where a slot's rows are contiguous (no row table, row stride 1:
// every exp1 column, and every slot of an OCCURS field, which the fused
// decoder keeps column-major) a column is read as the aligned 16-byte
// words it touches; a row table or a row stride reads element by element.
// So a flat OCCURS array's planes are read in whole sectors and
// transposed through shared memory: the output is record-major (j = row *
// S + s), written from the staged tile as runs of SC elements. A thread
// builds 16 bytes of output (4 int32 or float32, 2 int64 or float64 or 1
// decimal128) and stores them with one 16-byte store where they are
// contiguous and aligned. The value pass is one template instance a
// (source, output) class, chosen once a block, so an element costs only
// its own class's arithmetic. Its validity bits are packed in tile order
// as it goes (the lanes of a word OR theirs together with shuffles), and
// a thread then builds each bitmap word of the tile's output runs: a
// word the tile fills whole (with the bits past the array's end) is
// stored, a word it shares with another tile (at the ends of a run of SC
// slots) is OR-ed in, so the bitmap must start zeroed
// (ops/arrow_assemble.py `new_state` zeroes it). The null count is summed
// in the block and added once; the bad flag is set once a block. A block
// of 256 threads holds about 46 KB of shared memory and at most 64
// registers a thread: four blocks an SM. A block's fixed chain (its work
// entry, its descriptor, then its planes) is paid once a tile, so a wide
// array's tile is the largest that fits: 4,096 elements.
// High limbs, signs and dot counts (wide and per-row-scaled decimals, one
// slot each on the builder's routes) are read from global memory by the
// element, in row order.

// a request's decimal rule, read from the staged descriptor once a block
struct DecRule {
  int mode;
  int64_t shift, maxd;
};

// element (k, c) of the staged tile, of source kind SRC and output kind
// OUT: lo / hi receive the bits to store, zero under a null, `ok` its
// validity bit; returns the bad flag
template <int SRC, int OUT>
__device__ __forceinline__ bool scalar_element(
    const DecRule& rule, const int64_t* d, const uint8_t* __restrict__ src,
    const uint8_t* vals, const uint8_t* flags, const int32_t* rowv, int cst,
    int k, int c, int64_t s, uint64_t& lo, uint64_t& hi, bool& ok) {
  lo = hi = 0;
  ok = false;
  const int64_t row = rowv[k];
  if (row < 0) return false;   // hidden: null and zero
  const int slot = c * cst + k;
  const bool valid = flags[slot] != 0;
  ok = valid;
  if (OUT == OUT_I32 || OUT == OUT_I64) {
    if (valid) {
      lo = SRC == SRC_I32
          ? static_cast<uint64_t>(static_cast<int64_t>(
                reinterpret_cast<const int32_t*>(vals)[slot]))
          : reinterpret_cast<const uint64_t*>(vals)[slot];
    }
    return false;
  }
  if (OUT == OUT_F32 || OUT == OUT_F64) {
    if (valid) {
      if (SRC == SRC_F32) {
        const uint32_t b = reinterpret_cast<const uint32_t*>(vals)[slot];
        lo = OUT == OUT_F32 ? b
            : static_cast<uint64_t>(__double_as_longlong(
                  static_cast<double>(__uint_as_float(b))));
      } else {
        const uint64_t b = reinterpret_cast<const uint64_t*>(vals)[slot];
        lo = OUT == OUT_F64 ? b
            : __float_as_uint(static_cast<float>(__longlong_as_double(
                  static_cast<long long>(b))));
      }
    }
    return false;
  }
  // decimal128
  U128 mag{0, 0};
  bool neg;
  if (SRC == SRC_WIDE) {
    mag.lo = reinterpret_cast<const uint64_t*>(vals)[slot];
    mag.hi = load<uint64_t>(src, plane_at(d, P_HI, row, s, 8));
    neg = src[plane_at(d, P_NEG, row, s, 1)] != 0;
  } else {
    const int64_t iv = SRC == SRC_I32
        ? reinterpret_cast<const int32_t*>(vals)[slot]
        : reinterpret_cast<const int64_t*>(vals)[slot];
    neg = iv < 0;
    // |INT64_MIN| wraps to itself: its unsigned view is 2^63
    mag.lo = neg ? 0ull - static_cast<uint64_t>(iv)
                 : static_cast<uint64_t>(iv);
  }
  bool bad = false;
  U128 dec{0, 0};
  int64_t shift = rule.shift;
  if (rule.mode == DEC_DOTS) {
    shift -= load<int32_t>(src, plane_at(d, P_DOTS, row, s, 4));
  } else if (rule.mode == DEC_DIGITS) {
    // the int64 plane's digit count tops out at 19
    shift -= digit_count(mag);
  }
  if (valid) {
    // bounded by the declared precision (1..38), valid rows only
    if (shift < 0 || shift > 38) {
      bad = true;
    } else {
      bool over;
      dec = mul_pow10(mag, static_cast<int>(shift), &over);
      if (over || ge128(dec, kPow10[rule.maxd])) bad = true;
    }
    if (bad) dec = U128{0, 0};
  }
  if (neg && valid) {
    // two's complement of the 128-bit magnitude
    const uint64_t l = ~dec.lo + 1;
    dec.hi = ~dec.hi + (l == 0 ? 1 : 0);
    dec.lo = l;
  }
  if (valid) {
    lo = dec.lo;
    hi = dec.hi;
  }
  return bad;
}

// element i (0..V-1) of a 16-byte group of V elements into its words
template <int V>
__device__ __forceinline__ void pack(uint32_t (&w)[4], int i, uint64_t lo,
                                     uint64_t hi) {
  if (V == 4) {
    w[i] = static_cast<uint32_t>(lo);
  } else if (V == 2) {
    w[2 * i] = static_cast<uint32_t>(lo);
    w[2 * i + 1] = static_cast<uint32_t>(lo >> 32);
  } else {
    w[0] = static_cast<uint32_t>(lo);
    w[1] = static_cast<uint32_t>(lo >> 32);
    w[2] = static_cast<uint32_t>(hi);
    w[3] = static_cast<uint32_t>(hi >> 32);
  }
}

template <int OITEM>
__device__ __forceinline__ void store_scalar(uint8_t* values, int64_t e,
                                             uint64_t lo, uint64_t hi) {
  if (OITEM == 4) {
    reinterpret_cast<uint32_t*>(values)[e] = static_cast<uint32_t>(lo);
  } else if (OITEM == 8) {
    reinterpret_cast<uint64_t*>(values)[e] = lo;
  } else {
    reinterpret_cast<uint4*>(values)[e] = make_uint4(
        static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
        static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32));
  }
}

// the value pass of one tile, for one (source, output) class: 16 bytes
// of output a thread and a step, in output order; a group of V elements
// is one 16-byte store where it lies in one run of the output, aligned.
// The validity bits, in tile order, go to okw: the 32 / V lanes that
// hold a word's positions OR their bits together with shuffles (every
// lane runs every step, so the shuffles see the whole warp). Returns the
// bad flag.
template <int SRC, int OUT>
__device__ __forceinline__ bool tile_values(
    const DecRule& rule, const int64_t* d, const uint8_t* __restrict__ src,
    const uint8_t* vals, const uint8_t* flags, const int32_t* rowv,
    uint32_t* okw, int cst, int rt, int sc, int64_t k0, int64_t s0,
    int64_t S, uint8_t* __restrict__ values) {
  constexpr int OITEM = OUT == OUT_DEC ? 16
      : (OUT == OUT_I64 || OUT == OUT_F64) ? 8 : 4;
  constexpr int V = 16 / OITEM;
  const int cnt = rt * sc;
  const bool whole = sc == S;   // the tile's output is one run
  bool bad = false;
  for (int step = 0; step < cnt; step += kTile * V) {
    const int q0 = step + threadIdx.x * V;
    int k = sc == 1 ? q0 : q0 / sc;
    int c = q0 - k * sc;
    const int64_t e0 = (k0 + k) * S + s0 + c;
    const bool vec = q0 + V <= cnt && (e0 & (V - 1)) == 0
        && (whole || c + V <= sc);
    uint32_t w[4] = {0, 0, 0, 0};
    uint32_t oks = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (q0 + i < cnt) {
        uint64_t lo, hi;
        bool ok;
        bad |= scalar_element<SRC, OUT>(rule, d, src, vals, flags, rowv,
                                        cst, k, c, s0 + c, lo, hi, ok);
        oks |= static_cast<uint32_t>(ok) << i;
        if (vec) {
          pack<V>(w, i, lo, hi);
        } else {
          store_scalar<OITEM>(values, (k0 + k) * S + s0 + c, lo, hi);
        }
        if (++c == sc) {
          c = 0;
          ++k;
        }
      }
    }
    if (vec) {
      *reinterpret_cast<uint4*>(values + e0 * OITEM) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    oks <<= q0 & 31;
#pragma unroll
    for (int o = 1; o < 32 / V; o <<= 1) {
      oks |= __shfl_xor_sync(0xffffffffu, oks, o);
    }
    if ((threadIdx.x & (32 / V - 1)) == 0 && q0 < cnt) okw[q0 >> 5] = oks;
  }
  return bad;
}

// the 32 validity bits of tile positions [from, from + 32); positions
// outside [0, cnt) read 0
__device__ __forceinline__ uint32_t tile_bits(const uint32_t* okw, int cnt,
                                              int from) {
  const int a = from >> 5, sh = from & 31;   // floor division
  const int words = (cnt + 31) >> 5;
  const uint32_t lo = (a >= 0 && a < words) ? okw[a] : 0u;
  const uint32_t hi = (a + 1 >= 0 && a + 1 < words) ? okw[a + 1] : 0u;
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
}

// the bits b of a word with lo <= base + b < hi
__device__ __forceinline__ uint32_t bit_range(int base, int lo, int hi) {
  const int a = max(lo - base, 0), b = min(hi - base, 32);
  if (a >= b) return 0u;
  const uint32_t upto = b == 32 ? 0xffffffffu : (1u << b) - 1u;
  return upto & ~((1u << a) - 1u);
}

__global__ void __launch_bounds__(kTile, 4) arrow_scalars(
    const uint8_t* __restrict__ src, int64_t src_bytes,
    const uint8_t* __restrict__ aux, const int64_t* __restrict__ desc,
    const int2* __restrict__ work, uint8_t* __restrict__ out) {
  __shared__ int64_t d[D_NF];
  __shared__ __align__(16) uint8_t vals[kCap * 8];
  __shared__ uint8_t flags[kCap];
  __shared__ int32_t rowv[kRows];    // a tile row's source row, -1 hidden
  __shared__ uint32_t okw[kElems / 32];   // validity bits, tile order
  __shared__ int warp_nulls[kTile / 32];
  const int2 job = work[blockIdx.x];
  if (threadIdx.x < D_NF) {
    d[threadIdx.x] = desc[static_cast<int64_t>(job.x) * D_NF + threadIdx.x];
  }
  __syncthreads();
  const int64_t S = d[D_SLOTS], L = d[D_LEN];
  const int RT = static_cast<int>(d[D_RT]), SC = static_cast<int>(d[D_SC]);
  const int rtiles = static_cast<int>(d[D_RTILES]);
  const int64_t k0 = static_cast<int64_t>(job.y % rtiles) * RT;
  const int64_t s0 = static_cast<int64_t>(job.y / rtiles) * SC;
  const int rt = static_cast<int>(min64(RT, L / S - k0));
  const int sc = static_cast<int>(min64(SC, S - s0));
  const int cst = RT + 1;   // staged column stride, elements
  const int src_kind = static_cast<int>(d[D_SRC]);
  const int item = (src_kind == SRC_I32 || src_kind == SRC_F32) ? 4 : 8;
  const int64_t rows_tab = d[D_ROWS], mask = d[D_MASK];
  for (int k = threadIdx.x; k < rt; k += kTile) {
    const int64_t row = rows_tab >= 0
        ? load<int64_t>(aux, rows_tab + 8 * (k0 + k)) : k0 + k;
    rowv[k] = (mask < 0 || aux[mask + row] != 0) ? static_cast<int32_t>(row)
                                                 : -1;
  }
  if (rows_tab < 0 && (d[D_RSTRIDE] == 1 || rt == 1)) {
    // each slot's rows are one run of each plane: its aligned 16-byte
    // words (hidden rows are read too, and not used)
    const int64_t v0 = plane_at(d, P_VALUES, k0, s0, item);
    const int64_t f0 = plane_at(d, P_VALID, k0, s0, 1);
    const int64_t vstep = d[D_STEP + P_VALUES], fstep = d[D_STEP + P_VALID];
    const auto vrun = [=](int c) { return v0 + c * vstep; };
    if (item == 4) {
      stage_runs<4, 1>(vals, cst * 4, src, src_bytes, sc, rt * 4, vrun);
    } else {
      stage_runs<8, 1>(vals, cst * 8, src, src_bytes, sc, rt * 8, vrun);
    }
    stage_runs<1, 1>(flags, cst, src, src_bytes, sc, rt,
                  [=](int c) { return f0 + c * fstep; });
  } else {
    __syncthreads();   // rowv
    for (int q = threadIdx.x; q < sc * rt; q += kTile) {
      const int c = q / rt, k = q - c * rt;
      const int64_t row = rowv[k];
      if (row < 0) continue;
      const int slot = c * cst + k;
      flags[slot] = src[plane_at(d, P_VALID, row, s0 + c, 1)];
      const int64_t a = plane_at(d, P_VALUES, row, s0 + c, item);
      if (item == 4) {
        reinterpret_cast<uint32_t*>(vals)[slot] = load<uint32_t>(src, a);
      } else {
        reinterpret_cast<uint64_t*>(vals)[slot] = load<uint64_t>(src, a);
      }
    }
  }
  __syncthreads();

  // the value pass, specialized by (source, output) class
  const DecRule rule{static_cast<int>(d[D_DEC]), d[D_SHIFT], d[D_MAXD]};
  const int out_kind = static_cast<int>(d[D_OUT]);
  const int cnt = rt * sc;
  const bool whole = sc == S;   // the tile's output is one run
  uint8_t* values = out + d[D_VALUES];
  bool bad = false;
#define TILE_VALUES(SRC_, OUT_)                                             \
  case SRC_ * 8 + OUT_:                                                     \
    bad = tile_values<SRC_, OUT_>(rule, d, src, vals, flags, rowv, okw,     \
                                  cst, rt, sc, k0, s0, S, values);          \
    break;
  switch (src_kind * 8 + out_kind) {
    TILE_VALUES(SRC_I32, OUT_I32)
    TILE_VALUES(SRC_I32, OUT_I64)
    TILE_VALUES(SRC_I32, OUT_DEC)
    TILE_VALUES(SRC_I64, OUT_I32)
    TILE_VALUES(SRC_I64, OUT_I64)
    TILE_VALUES(SRC_I64, OUT_DEC)
    TILE_VALUES(SRC_F32, OUT_F32)
    TILE_VALUES(SRC_F32, OUT_F64)
    TILE_VALUES(SRC_F64, OUT_F32)
    TILE_VALUES(SRC_F64, OUT_F64)
    TILE_VALUES(SRC_WIDE, OUT_DEC)
    default: break;
  }
#undef TILE_VALUES
  __syncthreads();   // okw

  // validity words: a thread a word of the output, over each run of the
  // tile (one run of rt * S elements for whole rows, else a run of sc a
  // row, at most 32 elements and two words); a word the tile fills
  // (with the bits past the array's end) is stored, one it shares with
  // another tile is OR-ed in
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int run = whole ? cnt : sc;
  const int nruns = whole ? 1 : rt;
  const int wpr = (run + 31) / 32 + 1;
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(out + d[D_BITMAP]);
  int nulls = 0;
  for (int it = threadIdx.x; it < nruns * wpr; it += kTile) {
    const int g = it / wpr;
    const int64_t start = (k0 + g) * S + s0;
    const int64_t W = (start >> 5) + (it - g * wpr);
    if (W * 32 >= start + run) continue;
    const int x = static_cast<int>(W * 32 - start);   // run position of bit 0
    const uint32_t mine = bit_range(x, 0, run);
    const uint32_t bits = tile_bits(okw, cnt, g * sc + x) & mine;
    const int64_t left = L - W * 32;   // the word's bits inside the array
    const uint32_t past = bit_range(
        0, left <= 0 ? 0 : left >= 32 ? 32 : static_cast<int>(left), 32);
    if ((mine | past) == 0xffffffffu) {
      bitmap[W] = bits;
    } else if (bits) {
      atomicOr(bitmap + W, bits);
    }
    nulls += __popc(mine & ~bits);
  }
  for (int o = 16; o > 0; o >>= 1) {
    nulls += __shfl_down_sync(0xffffffffu, nulls, o);
  }
  if (lane == 0) warp_nulls[warp] = nulls;
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kTile / 32; ++w) total += warp_nulls[w];
    int64_t* counters = reinterpret_cast<int64_t*>(out)
        + static_cast<int64_t>(job.x) * C_NF;
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

__device__ __forceinline__ int64_t row_of(const uint8_t* aux,
                                          const int64_t* d, int64_t j) {
  return d[D_ROWS] >= 0 ? load<int64_t>(aux, d[D_ROWS] + 8 * j) : j;
}

__device__ __forceinline__ bool hidden(const uint8_t* aux, const int64_t* d,
                                       int64_t row) {
  return d[D_MASK] >= 0 && aux[d[D_MASK] + row] == 0;
}

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

__device__ __forceinline__ uint8_t* put_utf8(uint8_t* o, uint32_t u) {
  if (u < 0x80) {
    *o++ = static_cast<uint8_t>(u);
  } else if (u < 0x800) {
    *o++ = static_cast<uint8_t>(0xC0 | (u >> 6));
    *o++ = static_cast<uint8_t>(0x80 | (u & 0x3F));
  } else {
    *o++ = static_cast<uint8_t>(0xE0 | (u >> 12));
    *o++ = static_cast<uint8_t>(0x80 | ((u >> 6) & 0x3F));
    *o++ = static_cast<uint8_t>(0x80 | (u & 0x3F));
  }
  return o;
}

// the value of element j: its code points (null: blank) and trimmed extent
struct Value {
  const uint8_t* p;   // null for a hidden row: every code point is 0x20
  int wide;
  int64_t s, e;
};

__device__ Value value_of(const uint8_t* src, const uint8_t* aux,
                          const int64_t* d, int64_t j) {
  const int64_t row = row_of(aux, d, j);
  const int64_t w = d[D_WIDTH];
  const int wide = d[D_SRC] == SRC_CP16;
  Value v{nullptr, wide, 0, w};
  const int mode = static_cast<int>(d[D_TRIM]);
  if (hidden(aux, d, row)) {
    if (mode != TRIM_NONE) v.e = 0;   // blanks trim away
    return v;
  }
  v.p = src + plane_at(d, P_VALUES, row, 0, wide ? 2 : 1);
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

// The look-back's status word a tile, in a zeroed int64 scratch word:
// the flag in bits 62-63 (0: nothing yet, 1: the tile's aggregate, 2:
// the inclusive prefix of its array up to it), the array's OR-ed bad bit
// in bit 61, the value in bits 0-60; one 64-bit store publishes a flag
// with its value
constexpr int kFlagShift = 62;
constexpr uint64_t kAggregate = 1ull << kFlagShift;
constexpr uint64_t kInclusive = 2ull << kFlagShift;
constexpr uint64_t kBadBit = 1ull << 61;
constexpr uint64_t kValueMask = kBadBit - 1;

constexpr int kLook = 4;   // status words a lane reads a round

// one aligned 64-bit store: no reader sees a flag without its value, and
// nothing else a reader uses needs ordering before it
__device__ __forceinline__ void publish(unsigned long long* status,
                                        uint64_t flag, bool bad,
                                        int64_t value) {
  *reinterpret_cast<volatile unsigned long long*>(status) =
      flag | (bad ? kBadBit : 0ull)
      | (static_cast<uint64_t>(value) & kValueMask);
}

__device__ __forceinline__ uint64_t status_at(const unsigned long long* s,
                                              int64_t q) {
  return *reinterpret_cast<const volatile unsigned long long*>(s + q);
}

// What bounds it: bytes (each visible string's code points in, its int32
// length and its tile's int64 base out), and at one batch's shapes (a few
// hundred tiles, one wave) one launch's latency and the chain of loads
// and waits its blocks run. The simple design searched the request starts
// a block, read the descriptor from global memory at each use, walked
// each string a code point at a time from global memory, neighbouring
// threads a string width apart, and left the scan of the tile sums to a
// second launch whose work was a few hundred int64 values: two dependent
// block scans, a fence and an atomic, a launch's latency and nothing
// else.
//
// The design. One launch. A block takes its tile from a zeroed ticket
// (atomicAdd), not from blockIdx.x, so every tile it waits on started
// before it and the look-back always moves; the tile's (request, tile)
// entry is the plan's string work table, the one arrow_str_copy reads.
// One warp copies the descriptor into shared memory. The tile's rows and
// visibility are loaded, and its code points staged in shared memory
// with 16-byte loads as the copy stages them (two a thread in flight, not
// four: 32 registers a thread, eight blocks an SM): one run when its rows
// are contiguous, else a run a row. Each thread
// finds its string's trimmed extent, UTF-8 length and surrogate flag
// there; a tile whose code points overflow the buffer reads them from
// global memory, the simple design's path. A block reduction gives the
// tile's sum and bad flag. Warp 0 then publishes the tile's aggregate
// and looks back over its array's earlier tiles only (the scan restarts
// at each array's first tile, which publishes its inclusive prefix at
// once): a round issues the loads of 128 earlier status words at once
// and takes them in order of distance, 32 at a time, down to the nearest
// inclusive prefix, waiting only on words it counts. It publishes its own
// prefix and writes its exclusive base to tile_sums, which ends as the
// plain version leaves it. A status word is one 64-bit store (flag, bad
// bit, value), so no reader sees a flag without its value and a publish
// needs no fence. The bad bit rides in the status words, so an array's
// last tile sees a surrogate in any of its tiles; it writes the array's
// bad flag and total, then fences. The last tile to finish (a count of
// finished tiles) scans the totals into each array's data start and the
// grand total.
__global__ void __launch_bounds__(kTile) arrow_str_lengths(
    const uint8_t* __restrict__ src, int64_t src_bytes,
    const uint8_t* __restrict__ aux, const int64_t* __restrict__ desc,
    const int2* __restrict__ work, const int64_t* __restrict__ ids,
    int64_t nreq, int64_t tiles, uint8_t* __restrict__ out,
    int64_t* __restrict__ tile_sums, unsigned long long* status,
    unsigned int* order, int64_t grand_slot) {
  __shared__ int64_t d[D_NF];
  __shared__ __align__(16) uint8_t cps[kStrCp];
  __shared__ int32_t rowv[kTile];
  __shared__ int64_t part[kTile / 32];
  __shared__ int64_t tile_at, chunk;
  __shared__ int last;
  const int tid = threadIdx.x;
  if (tid == 0) tile_at = atomicAdd(order, 1u);
  __syncthreads();
  const int64_t tile = tile_at;
  // a launch over scratch that was not zeroed (`new_state`) takes tickets
  // past the last tile: it does nothing rather than wait on tiles no
  // block holds
  if (tile >= tiles) return;
  const int2 job = work[tile];
  if (tid < D_NF) d[tid] = desc[static_cast<int64_t>(job.x) * D_NF + tid];
  __syncthreads();
  const int64_t j0 = static_cast<int64_t>(job.y) * kTile, j = j0 + tid;
  const int n_in = static_cast<int>(min64(kTile, d[D_LEN] - j0));
  const bool in = tid < n_in;
  const int w = static_cast<int>(d[D_WIDTH]);
  const int wide = d[D_SRC] == SRC_CP16;
  const int cs = wide ? 2 : 1;
  const int rb = w * cs;   // a row's code-point bytes
  const bool fits = static_cast<int64_t>(n_in) * rb <= kStrCp;
  const bool run = d[D_ROWS] < 0 && (d[D_RSTRIDE] == w || n_in == 1);
  if (in) {
    const int64_t row = row_of(aux, d, j);
    rowv[tid] = hidden(aux, d, row) ? -1 : static_cast<int32_t>(row);
  }
  if (fits && run) {
    const int64_t a0 = plane_at(d, P_VALUES, j0, 0, cs);
    const auto one = [=](int) { return a0; };
    if (wide) stage_runs<2, 2>(cps, 0, src, src_bytes, 1, n_in * rb, one);
    else stage_runs<1, 2>(cps, 0, src, src_bytes, 1, n_in * rb, one);
  }
  __syncthreads();   // rowv, the run
  if (fits && !run) {
    const auto row_run = [&](int i) -> int64_t {
      return rowv[i] < 0 ? -1 : plane_at(d, P_VALUES, rowv[i], 0, cs);
    };
    if (wide) stage_runs<2, 2>(cps, rb, src, src_bytes, n_in, rb, row_run);
    else stage_runs<1, 2>(cps, rb, src, src_bytes, n_in, rb, row_run);
    __syncthreads();
  }
  int32_t len = 0;
  bool bad = false;
  if (in) {
    if (fits) {
      const uint16_t* cps16 = reinterpret_cast<const uint16_t*>(cps);
      const int mode = static_cast<int>(d[D_TRIM]);
      const bool blank = rowv[tid] < 0;
      const int r0 = tid * w;
      const auto cp = [&](int k) -> uint32_t {
        return blank ? 0x20u : wide ? cps16[r0 + k] : cps[r0 + k];
      };
      int s = 0, e = w;
      if (mode == TRIM_BOTH || mode == TRIM_LEFT) {
        while (s < e && trims(cp(s), mode)) ++s;
      }
      if (mode == TRIM_BOTH || mode == TRIM_RIGHT) {
        while (e > s && trims(cp(e - 1), mode)) --e;
      }
      for (int k = s; k < e; ++k) {
        const uint32_t c = cp(k);
        len += utf8_len(c);
        bad |= (c >= 0xD800 && c <= 0xDFFF);
      }
    } else {
      const Value v = value_of(src, aux, d, j);
      for (int64_t k = v.s; k < v.e; ++k) {
        const uint32_t c = v.p ? code_point(v.p, v.wide, k) : 0x20;
        len += utf8_len(c);
        bad |= (c >= 0xD800 && c <= 0xDFFF);
      }
    }
    int32_t* offsets = reinterpret_cast<int32_t*>(out + d[D_VALUES]);
    offsets[j + 1] = len;
    if (j == 0) offsets[0] = 0;
  }
  const int64_t sum = block_sum<int64_t>(len, part);   // thread 0's
  const int any_bad = __syncthreads_or(bad);
  if (tid < 32) {
    const int64_t agg = __shfl_sync(0xffffffffu, sum, 0);
    int64_t base = 0;   // lane 0's
    bool base_bad = false;
    if (job.y > 0) {
      if (tid == 0) publish(status + tile, kAggregate, any_bad, agg);
      const int64_t first = tile - job.y;   // the array's first tile
      // a round issues the loads of 32 x kLook earlier words at once,
      // lane l word r at distance 32 r + l + 1, then takes the words in
      // order of distance, 32 at a time, waiting only on those it counts
      // (a tile that took its ticket earlier publishes its aggregate
      // without waiting), down to the nearest inclusive prefix; a word
      // before the array reads as an empty inclusive prefix, and the
      // first tile's own prefix always stops the scan before it
      for (int64_t top = tile - 1;; top -= 32 * kLook) {
        uint64_t st[kLook];
#pragma unroll
        for (int r = 0; r < kLook; ++r) {
          const int64_t q = top - 32 * r - tid;
          st[r] = q >= first ? status_at(status, q) : kInclusive;
        }
        int64_t v = 0;
        bool b = false, found = false;
#pragma unroll
        for (int r = 0; r < kLook; ++r) {
          if (found) break;
          while ((st[r] >> kFlagShift) == 0) {
            st[r] = status_at(status, top - 32 * r - tid);
          }
          const unsigned inclusive =
              __ballot_sync(0xffffffffu, (st[r] >> kFlagShift) == 2);
          const int stop = inclusive
              ? __ffs(static_cast<int>(inclusive)) - 1 : 31;
          if (tid <= stop) {
            v += static_cast<int64_t>(st[r] & kValueMask);
            b |= (st[r] & kBadBit) != 0;
          }
          found = inclusive != 0;
        }
        for (int o = 16; o > 0; o >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, o);
        }
        base += v;
        base_bad |= __any_sync(0xffffffffu, b) != 0;
        if (found) break;
      }
    }
    if (tid == 0) {
      const int64_t total = base + agg;
      const bool req_bad = base_bad || any_bad;
      publish(status + tile, kInclusive, req_bad, total);
      tile_sums[tile] = base;
      if (job.y == (d[D_LEN] - 1) / kTile) {
        // the array's last tile: its inclusive prefix is the total
        int64_t* c = reinterpret_cast<int64_t*>(out)
            + static_cast<int64_t>(job.x) * C_NF;
        const bool rebuild = req_bad || total > 2147483647LL;
        if (rebuild) c[C_BAD] = 1;
        // a request whose column the caller rebuilds reserves no data
        c[C_TOTAL] = rebuild ? 0 : total;
        __threadfence();   // the totals, before the count that reads them
      }
      last = atomicAdd(order + 1, 1u) == static_cast<unsigned>(tiles - 1);
    }
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int64_t* counters = reinterpret_cast<int64_t*>(out);
  int64_t carry = 0;
  for (int64_t b0 = 0; b0 < nreq; b0 += kTile) {
    const int64_t k = b0 + tid;
    const int64_t x = k < nreq
        ? *reinterpret_cast<volatile int64_t*>(counters + ids[k] * C_NF
                                               + C_TOTAL)
        : 0;
    const int64_t inc = block_scan<int64_t>(x, part);
    if (k < nreq) counters[ids[k] * C_NF + C_START] = carry + inc - x;
    if (tid == kTile - 1) chunk = inc;
    __syncthreads();
    carry += chunk;
    __syncthreads();
  }
  if (tid == 0) counters[grand_slot] = carry;
}

// What bounds it: bytes (each visible string's code points in, its UTF-8
// bytes and offset out), and at one batch's shapes latency. The simple
// design searched the request starts, read the descriptor, row table,
// mask and slot table from global memory, and then each thread walked its
// own string alone, re-reading the code points the lengths step had
// walked a byte (or uint16) at a time, neighbouring threads a string
// width apart, and wrote its UTF-8 a byte at a time to unaligned
// addresses.
//
// The design. A block takes one tile of 256 strings (the tiles of
// arrow_str_lengths), named by its work entry; one
// warp copies the descriptor and the request's bad flag and data start
// into shared memory. The block scan of the lengths gives the int32
// offsets, as before, and the tile's UTF-8 bytes are the contiguous range
// [data start + tile base, + tile sum) of the output. The tile's code
// points are staged in shared memory with 16-byte loads, four a thread in
// flight: one run when its rows are contiguous (no row table, row stride
// = width), issued with the row and mask loads before the block scan, or
// a run a row after it. Each string's trimmed extent is found in shared
// memory, and its bytes are built in a shared buffer laid out with the
// output range's alignment: an all-ASCII string (UTF-8 length = code
// points) is cut in items of 16 code points, a string with any other code
// point is one item, encoded as before, and the block's threads take the
// items in turn. The range is then written with aligned 16-byte stores,
// the bytes at its ragged ends one at a time. A tile whose code points
// (256 x width x 1 or 2 bytes) or UTF-8 bytes do not fit the shared
// buffers writes directly: each thread its own string from global memory,
// the simple design's path. Hidden rows stay blank, and a column marked
// bad is skipped. At one batch's shapes (a few hundred tiles, one wave)
// the kernel stays held by its chain of loads: work entry, descriptor,
// then lengths and code points.
__global__ void __launch_bounds__(kTile) arrow_str_copy(
    const uint8_t* __restrict__ src, int64_t src_bytes,
    const uint8_t* __restrict__ aux, const int64_t* __restrict__ desc,
    const int2* __restrict__ work, uint8_t* __restrict__ out,
    const int64_t* __restrict__ tile_sums, int64_t data_off) {
  __shared__ int64_t d[D_NF + 2];   // descriptor, bad flag, data start
  __shared__ __align__(16) uint8_t cps[kStrCp];
  __shared__ __align__(16) uint8_t utf[kStrOut + 16];
  __shared__ int32_t rowv[kTile], ext_s[kTile], ext_e[kTile], at[kTile];
  __shared__ int32_t item_end[kTile];
  __shared__ uint8_t ascii[kTile];
  __shared__ int32_t part[kTile / 32];
  __shared__ int32_t tile_bytes, tile_items;
  const int2 job = work[blockIdx.x];
  const int64_t base = tile_sums[blockIdx.x];
  const int64_t* counters = reinterpret_cast<const int64_t*>(out)
      + static_cast<int64_t>(job.x) * C_NF;
  if (threadIdx.x < D_NF) {
    d[threadIdx.x] = desc[static_cast<int64_t>(job.x) * D_NF + threadIdx.x];
  } else if (threadIdx.x == D_NF) {
    d[D_NF] = counters[C_BAD];
  } else if (threadIdx.x == D_NF + 1) {
    d[D_NF + 1] = counters[C_START];
  }
  __syncthreads();
  if (d[D_NF]) return;   // the caller rebuilds this column
  const int tid = threadIdx.x;
  const int64_t j0 = static_cast<int64_t>(job.y) * kTile, j = j0 + tid;
  const int n_in = static_cast<int>(min64(kTile, d[D_LEN] - j0));
  const bool in = tid < n_in;
  int32_t* offsets = reinterpret_cast<int32_t*>(out + d[D_VALUES]);
  const int32_t len = in ? offsets[j + 1] : 0;
  const int w = static_cast<int>(d[D_WIDTH]);
  const int wide = d[D_SRC] == SRC_CP16;
  const int cs = wide ? 2 : 1;
  const int rb = w * cs;   // a row's code-point bytes
  const bool fits = static_cast<int64_t>(n_in) * rb <= kStrCp;
  const bool run = d[D_ROWS] < 0 && (d[D_RSTRIDE] == w || n_in == 1);
  // the loads that need only the descriptor go out before the scan:
  // the rows and their visibility, and a run of the tile's code points
  if (in) {
    const int64_t row = row_of(aux, d, j);
    rowv[tid] = hidden(aux, d, row) ? -1 : static_cast<int32_t>(row);
  }
  if (fits && run) {
    const int64_t a0 = plane_at(d, P_VALUES, j0, 0, cs);
    const auto one = [=](int) { return a0; };
    if (wide) stage_runs<2, 4>(cps, 0, src, src_bytes, 1, n_in * rb, one);
    else stage_runs<1, 4>(cps, 0, src, src_bytes, 1, n_in * rb, one);
  }
  const int32_t inc = block_scan<int32_t>(len, part);   // (syncs)
  if (tid == kTile - 1) tile_bytes = inc;
  if (in) offsets[j + 1] = static_cast<int32_t>(base + inc);
  const int64_t dst = data_off + d[D_NF + 1] + base;   // bytes into out
  __syncthreads();   // tile_bytes
  const int T = tile_bytes;
  const int mis = static_cast<int>(dst & 15);   // out is 16-byte aligned
  if (!fits || mis + T > kStrOut) {
    if (in) {
      uint8_t* o = out + dst + (inc - len);
      const Value v = value_of(src, aux, d, j);
      for (int64_t k = v.s; k < v.e; ++k) {
        o = put_utf8(o, v.p ? code_point(v.p, v.wide, k) : 0x20);
      }
    }
    return;
  }
  if (!run) {
    // a run a row (rowv is visible since the scan)
    const auto row_run = [&](int i) -> int64_t {
      return rowv[i] < 0 ? -1 : plane_at(d, P_VALUES, rowv[i], 0, cs);
    };
    if (wide) stage_runs<2, 4>(cps, rb, src, src_bytes, n_in, rb, row_run);
    else stage_runs<1, 4>(cps, rb, src, src_bytes, n_in, rb, row_run);
    __syncthreads();
  }
  // each string's trimmed extent, its place in the tile's bytes, items
  const uint16_t* cps16 = reinterpret_cast<const uint16_t*>(cps);
  int32_t items = 0;
  if (in) {
    const int mode = static_cast<int>(d[D_TRIM]);
    const bool blank = rowv[tid] < 0;
    int s = 0, e = w;
    const int r0 = tid * w;
    if (mode == TRIM_BOTH || mode == TRIM_LEFT) {
      while (s < e && trims(blank ? 0x20u : wide ? cps16[r0 + s]
                                          : cps[r0 + s], mode)) ++s;
    }
    if (mode == TRIM_BOTH || mode == TRIM_RIGHT) {
      while (e > s && trims(blank ? 0x20u : wide ? cps16[r0 + e - 1]
                                          : cps[r0 + e - 1], mode)) --e;
    }
    ext_s[tid] = s;
    ext_e[tid] = e;
    at[tid] = mis + inc - len;
    ascii[tid] = len == e - s;
    items = e > s ? (len == e - s ? (e - s + 15) / 16 : 1) : 0;
  }
  const int32_t iinc = block_scan<int32_t>(items, part);
  item_end[tid] = iinc;
  if (tid == kTile - 1) tile_items = iinc;
  __syncthreads();
  for (int it = tid; it < tile_items; it += kTile) {
    int lo = 0, hi = n_in - 1;   // the first string whose items end past it
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (item_end[mid] > it) hi = mid; else lo = mid + 1;
    }
    const int i = lo, r0 = i * w;
    const bool blank = rowv[i] < 0;
    const int s = ext_s[i], e = ext_e[i];
    uint8_t* o = utf + at[i];
    if (ascii[i]) {
      const int first = i ? item_end[i - 1] : 0;
      const int k1 = s + 16 * (it - first), k2 = min(e, k1 + 16);
      for (int k = k1; k < k2; ++k) {
        o[k - s] = blank ? 0x20 : static_cast<uint8_t>(
            wide ? cps16[r0 + k] : cps[r0 + k]);
      }
    } else {
      for (int k = s; k < e; ++k) {
        o = put_utf8(o, blank ? 0x20u : wide ? cps16[r0 + k] : cps[r0 + k]);
      }
    }
  }
  __syncthreads();
  // the tile's range [dst, dst + T): whole aligned words, ragged ends
  const int64_t g0 = dst - mis;
  for (int q = tid; q < (mis + T + 15) / 16; q += kTile) {
    const int64_t g = g0 + 16 * q;
    if (g >= dst && g + 16 <= dst + T) {
      *reinterpret_cast<uint4*>(out + g) =
          *reinterpret_cast<const uint4*>(utf + 16 * q);
    } else {
      for (int b = 0; b < 16; ++b) {
        if (g + b >= dst && g + b < dst + T) out[g + b] = utf[16 * q + b];
      }
    }
  }
}

}  // namespace

// Every entry launches on `stream` and returns the CUDA error (0 = none).
// `src` and `out` are 16-byte aligned; `src_bytes` is the source's size.

// `work`: an (int32 request, int32 tile) pair a block; `out`'s counters
// and validity words start zeroed
extern "C" int cobrix_arrow_scalars(const void* src, int64_t src_bytes,
                                    const void* aux, const void* desc,
                                    const void* work, int64_t blocks,
                                    void* out, void* stream) {
  if (blocks == 0) return 0;
  arrow_scalars<<<static_cast<unsigned>(blocks), kTile, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_bytes,
      static_cast<const uint8_t*>(aux), static_cast<const int64_t*>(desc),
      static_cast<const int2*>(work), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `work`: an (int32 request, int32 tile of the request) pair a string
// tile, request by request; `ids`: the string requests in that order;
// `scratch`: tiles + 1 zeroed int64 words, a look-back status word a
// tile, then the tile ticket and the count of finished tiles (two
// uint32); counters[grand_slot] (int64 words of `out`) receives the sum
// of the requests' totals
extern "C" int cobrix_arrow_str_lengths(const void* src, int64_t src_bytes,
                                        const void* aux, const void* desc,
                                        const void* work, const void* ids,
                                        int64_t nreq, int64_t tiles,
                                        void* out, void* tile_sums,
                                        void* scratch, int64_t grand_slot,
                                        void* stream) {
  if (tiles == 0) return 0;
  auto* status = static_cast<unsigned long long*>(scratch);
  arrow_str_lengths<<<static_cast<unsigned>(tiles), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_bytes,
      static_cast<const uint8_t*>(aux), static_cast<const int64_t*>(desc),
      static_cast<const int2*>(work), static_cast<const int64_t*>(ids), nreq,
      tiles, static_cast<uint8_t*>(out), static_cast<int64_t*>(tile_sums),
      status, reinterpret_cast<unsigned int*>(status + tiles), grand_slot);
  return static_cast<int>(cudaGetLastError());
}

// `work`: an (int32 request, int32 tile of the request) pair a string
// tile, in the order of the tile sums
extern "C" int cobrix_arrow_str_copy(const void* src, int64_t src_bytes,
                                     const void* aux, const void* desc,
                                     const void* work, int64_t tiles,
                                     void* out, const void* tile_sums,
                                     int64_t data_off, void* stream) {
  if (tiles == 0) return 0;
  arrow_str_copy<<<static_cast<unsigned>(tiles), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_bytes,
      static_cast<const uint8_t*>(aux), static_cast<const int64_t*>(desc),
      static_cast<const int2*>(work), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(tile_sums), data_off);
  return static_cast<int>(cudaGetLastError());
}
