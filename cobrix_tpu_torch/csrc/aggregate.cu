// Masked, scaled per-field sum, count, min and max over the fused planes,
// for Hopper (sm_90a).
//
// Replaces the reduction body of cobrix_tpu/parallel/query.py
// (DeviceAggregator._build, the `agg` program after the decode), which the
// JAX package runs as XLA reductions: for every field the query asks for,
// and every column of every fused group that field owns (narrow int32 or
// int64 values, wide uint128 hi/lo limbs with a negative plane; COMP,
// COMP-3 and zoned DISPLAY), the value is made a float64 in field units
// and reduced over the rows below n (read from device memory) whose valid
// flag is set:
//   narrow: v = double(value); wide: v = +-(double(hi) * 2^64 + double(lo))
//   with hi and lo converted as UNSIGNED (the JAX planes are uint64; here
//   they are int64 bit patterns);
//   then v *= the host's 10.0 ** e (a constant exponent), or
//   10 ** -dots (the DISPLAY dot plane), or 10 ** -(digits - sf) with the
//   exact decimal digit count of the integer value or limbs (binary PIC P,
//   columnar._digit_count / _digit_count_limbs). Powers of ten come from
//   one table of 10.0 ** -k the wrapper uploads (ops/aggregate.py), which
//   the plain version indexes too, so both give the same double.
// Every product and sum is rounded on its own (__dmul_rn / __dadd_rn: no
// fused multiply-add), so each value is the plain version's bit for bit;
// sums differ from it only by the order of additions, min and max not at
// all. Min and max travel as order-preserving int64 keys of the double
// (bits, or bits ^ 0x7fff... for negative doubles).
//
// What bounds it: the bytes. The function reads each live value once (4
// or 8 bytes; 17 for a wide value's limbs and sign; 4 more for a DISPLAY
// dot count) and its valid flag (1 byte); the digit counts and the
// power-of-ten lookups are a few integer operations a value. The planes
// are column-major [rows, N], so rows [r0, r1) of one column are
// contiguous in every plane.
//
// The design (ops/aggregate.py builds the tables):
// * Work is cut in units of 16 rows of one column. A unit is read with
//   whole 16-byte loads, one for its 16 flags, 4 (int32) or 8 (int64)
//   for its values, where every plane's row is 16-byte aligned (all are
//   when N is a multiple of 16, as the block query's and the on-HBM
//   pipeline's batches are); a column's last, partial unit and a row that
//   is not aligned go row by row. A thread loads two int32 units before
//   it reduces either, so 160 bytes a thread are in flight. Where the
//   value is a non-decreasing function of the integer (no scale, or a
//   constant one), a unit's min and max are taken on the integers and
//   converted once, and unscaled int32 values sum exactly in 64 bits.
// * The columns, sorted on the host by kind, scale mode and field, form
//   classes of one (kind, mode) and, inside a class, runs of one field.
//   Each class present is one launch of its own template instance, so the
//   int32 kernel of the query's shapes holds no register for the wide or
//   PIC P arithmetic; the launches after the first are programmatic
//   dependent launches, scheduled while the one before still runs. A
//   grid is as many blocks as fit on every SM at once (the occupancy
//   API); a class's work is a flat line of (row bytes x units)
//   positions, and block b takes the units that start in its equal share
//   of the line. The 2,304-row blocks of the query and a 63,232-row
//   pipeline batch both fill every SM.
// * No atomics. A block reduces its units by run and writes one partial
//   to slot slot0[class] + run + b of a scratch buffer; a last kernel,
//   launched behind the classes, combines each field's partials (its
//   runs in class order, each run's blocks in order; a warp a field) and
//   adds them to the field's outputs. The order of every addition is
//   fixed by N, n, the spec and the card, so the sums are the same from
//   call to call.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnit = 16;     // rows a unit
constexpr int kClasses = 12;  // (kind, mode) pairs
// launch bounds: at most 128 registers a thread, two blocks of 256 an
// SM (the int32 kernels take 120-128; capped at 85 for a third block they
// spilled)
constexpr int kMinBlocksPerSm = 2;

// descriptor fields (ops/aggregate.py _DESC_FIELDS)
enum Desc { D_VALUE = 0, D_LO, D_NEG, D_VALID, D_DOTS, D_KIND, D_MODE, D_SF,
            D_FIELD, D_FIELDS };
enum Kind { K_I32 = 0, K_I64 = 1, K_WIDE = 2 };
enum Mode { M_NONE = 0, M_CONST = 1, M_DOTS = 2, M_DIGITS = 3 };
// class and run table fields (ops/aggregate.py _CLASS_FIELDS, _RUN_FIELDS)
enum Class { C_KIND = 0, C_MODE, C_WEIGHT, C_ROW_BYTES, C_RUN0, C_RUN1,
             C_FIELDS };
enum Run { R_COL0 = 0, R_COL1, R_START, R_FIELD, R_CLASS, R_FIELDS };

struct Partial {  // 32 bytes (ops/aggregate.py PARTIAL_BYTES)
  double sum;
  long long lo, hi;  // min and max keys
  int count, pad;
};

struct Agg {
  const int32_t* i32;
  const int64_t* i64;
  const uint8_t* bools;
  int64_t N;  // a plane row's length: the batch's (padded) rows
  const int32_t* desc;
  const double* factor;
  const double* pow10;  // pow10[k] = 10.0 ** -k
  int pow10_size;
  const int64_t* classes;     // [n_classes, C_FIELDS]
  const int64_t* runs;        // [n_runs, R_FIELDS]
  const int64_t* field_ptr;   // [n_out + 1]: a field's runs in field_runs
  const int64_t* field_runs;  // [n_runs] run ids by field, then class
  int n_out;
  const int32_t* n_dev;  // live rows on the device, or null: n_host
  int64_t n_host;
  int64_t grid[kClasses];   // blocks of each class's launch
  int64_t slot0[kClasses];  // its first partial slot, less its first run
  Partial* partials;
  double* sums;
  int32_t* counts;
  long long* mins;
  long long* maxs;
};

struct Acc {
  double sum;
  int count;
  long long lo, hi;  // min and max keys
};

__device__ __forceinline__ Acc empty_acc() {
  return Acc{0.0, 0, 0x7fffffffffffffffLL, -0x7fffffffffffffffLL - 1};
}

__device__ __forceinline__ void merge(Acc& acc, double sum, int count,
                                      long long lo, long long hi) {
  acc.sum = __dadd_rn(acc.sum, sum);
  acc.count += count;
  acc.lo = lo < acc.lo ? lo : acc.lo;
  acc.hi = hi > acc.hi ? hi : acc.hi;
}

// One class's split: live rows, units a column, the flat extent (row
// bytes x units) and the blocks that share it (each a non-empty share).
struct Split {
  int64_t live, units, total, blocks;
};

__device__ __forceinline__ Split split_of(const Agg& a, int64_t row_bytes,
                                          int64_t grid) {
  const int64_t n = a.n_dev != nullptr ? static_cast<int64_t>(*a.n_dev)
                                       : a.n_host;
  Split s;
  s.live = n < 0 ? 0 : (n < a.N ? n : a.N);
  s.units = (s.live + kUnit - 1) / kUnit;
  s.total = row_bytes * s.units;
  s.blocks = s.total < grid ? s.total : grid;
  return s;
}

// block b's share of the flat line is [share_start(b), share_start(b + 1))
__device__ __forceinline__ int64_t share_start(const Split& s, int64_t b) {
  return b * s.total / s.blocks;
}

// the block whose share holds position w (0 <= w < total)
__device__ __forceinline__ int64_t block_of(const Split& s, int64_t w) {
  return ((w + 1) * s.blocks - 1) / s.total;
}

__device__ __forceinline__ long long order_key(double v) {
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

__device__ __forceinline__ void add(Acc& acc, double v) {
  const long long k = order_key(v);
  merge(acc, v, 1, k, k);
}

__device__ __forceinline__ double pow10_neg(const Agg& a, int64_t k) {
  return (k >= 0 && k < a.pow10_size) ? __ldg(a.pow10 + k)
                                      : pow(10.0, -static_cast<double>(k));
}

// decimal digits of |v| (int64 min: 19), columnar._digit_count
__device__ __forceinline__ int digit_count(long long v) {
  if (v == (-0x7fffffffffffffffLL - 1)) return 19;
  const unsigned long long a = v < 0 ? 0ull - static_cast<unsigned long long>(v)
                                     : static_cast<unsigned long long>(v);
  int nd = 1;
  unsigned long long p = 10;
#pragma unroll
  for (int k = 1; k < 19; ++k) {
    nd += a >= p;
    p *= 10;
  }
  return nd;
}

// decimal digits of the uint128 magnitude (hi, lo), _digit_count_limbs
__device__ __forceinline__ int digit_count_limbs(unsigned long long hi,
                                                 unsigned long long lo) {
  const unsigned __int128 v = (static_cast<unsigned __int128>(hi) << 64) | lo;
  unsigned __int128 p = 10;
  int nd = 1;
#pragma unroll
  for (int k = 1; k < 39; ++k) {
    nd += v >= p;
    p *= 10;
  }
  return nd;
}

// One row's value in field units: x is the int32 value (sign-extended),
// the int64 value or a wide value's hi limb.
template <int kKind, int kMode>
__device__ __forceinline__ double value_of(const Agg& a, unsigned long long x,
                                           unsigned long long lo, bool neg,
                                           long long dots, int sf, double f) {
  double v;
  int digits = 0;
  if constexpr (kKind == K_WIDE) {
    const double mag = __dadd_rn(
        __dmul_rn(__ull2double_rn(x), 18446744073709551616.0),
        __ull2double_rn(lo));
    v = neg ? -mag : mag;
    if constexpr (kMode == M_DIGITS) digits = digit_count_limbs(x, lo);
  } else {
    v = __ll2double_rn(static_cast<long long>(x));  // exact for int32 values
    if constexpr (kMode == M_DIGITS)
      digits = digit_count(static_cast<long long>(x));
  }
  if constexpr (kMode == M_CONST) {
    v = __dmul_rn(v, f);
  } else if constexpr (kMode == M_DOTS) {
    v = __dmul_rn(v, pow10_neg(a, dots));
  } else if constexpr (kMode == M_DIGITS) {
    v = __dmul_rn(v, pow10_neg(a, static_cast<int64_t>(digits) - sf));
  }
  return v;
}

// ---------------------------------------------------------------------------
// one column's rows: 16-byte words of a unit, or row by row
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lane_word(const uint4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

template <int kWords>
__device__ __forceinline__ void load_words(const void* p, uint4 (&w)[kWords]) {
  const uint4* q = static_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = __ldg(q + i);
}

__device__ __forceinline__ uint32_t byte_at(const uint4 (&w)[1], int i) {
  return (lane_word(w[0], i >> 2) >> (8 * (i & 3))) & 0xffu;
}

__device__ __forceinline__ long long i32_at(const uint4 (&w)[4], int i) {
  return static_cast<long long>(static_cast<int32_t>(lane_word(w[i >> 2], i & 3)));
}

__device__ __forceinline__ unsigned long long u64_at(const uint4 (&w)[8],
                                                     int i) {
  const uint4& q = w[i >> 1];
  const int j = 2 * (i & 1);
  return (static_cast<unsigned long long>(lane_word(q, j + 1)) << 32) |
         lane_word(q, j);
}

// The planes a column of kind kKind in mode kMode reads, at row r0.
template <int kKind, int kMode>
struct Rows {
  const uint8_t* ok;
  const void* value;  // int32 for K_I32, else int64 (a wide value's hi)
  const int64_t* lo;
  const uint8_t* neg;
  const int32_t* dots;

  __device__ __forceinline__ Rows(const Agg& a, const int32_t* d, int64_t r0) {
    ok = a.bools + static_cast<int64_t>(__ldg(d + D_VALID)) * a.N + r0;
    const int64_t v = static_cast<int64_t>(__ldg(d + D_VALUE)) * a.N + r0;
    if constexpr (kKind == K_I32) {
      value = a.i32 + v;
    } else {
      value = a.i64 + v;
    }
    lo = nullptr;
    neg = nullptr;
    dots = nullptr;
    if constexpr (kKind == K_WIDE) {
      lo = a.i64 + static_cast<int64_t>(__ldg(d + D_LO)) * a.N + r0;
      neg = a.bools + static_cast<int64_t>(__ldg(d + D_NEG)) * a.N + r0;
    }
    if constexpr (kMode == M_DOTS)
      dots = a.i32 + static_cast<int64_t>(__ldg(d + D_DOTS)) * a.N + r0;
  }

  // every plane's row 16-byte aligned: a full unit loads as whole words
  __device__ __forceinline__ bool aligned() const {
    uintptr_t bits = reinterpret_cast<uintptr_t>(ok) |
                     reinterpret_cast<uintptr_t>(value);
    if constexpr (kKind == K_WIDE)
      bits |= reinterpret_cast<uintptr_t>(lo) |
              reinterpret_cast<uintptr_t>(neg);
    if constexpr (kMode == M_DOTS) bits |= reinterpret_cast<uintptr_t>(dots);
    return (bits & 15) == 0;
  }
};

// the words of one full, aligned unit (16 rows) of a column
template <int kKind, int kMode>
struct Unit {
  uint4 ok[1];
  uint4 value[kKind == K_I32 ? 4 : 8];
  uint4 lo[kKind == K_WIDE ? 8 : 1];
  uint4 neg[1];
  uint4 dots[kMode == M_DOTS ? 4 : 1];
  int sf;
  double f;
  bool full;  // a unit was loaded

  __device__ __forceinline__ void load(const Rows<kKind, kMode>& r, int sf_,
                                       double f_) {
    load_words(r.ok, ok);
    load_words(r.value, value);
    if constexpr (kKind == K_WIDE) {
      load_words(r.lo, lo);
      load_words(r.neg, neg);
    }
    if constexpr (kMode == M_DOTS) load_words(r.dots, dots);
    sf = sf_;
    f = f_;
    full = true;
  }

  __device__ __forceinline__ void reduce(const Agg& a, Acc& acc) const {
    if constexpr (kKind != K_WIDE && (kMode == M_NONE || kMode == M_CONST)) {
      // A value here is a non-decreasing function of the integer (the
      // conversion and a product by 10.0 ** e > 0 both round to nearest),
      // so the unit's min and max are those of its smallest and largest
      // valid integer: two conversions a unit, not sixteen keys. int32
      // values without a scale sum exactly in 64 bits (16 of them stay
      // far below 2 ** 53), which is the double sum in some order.
      using Int = std::conditional_t<kKind == K_I32, int, long long>;
      Int mn, mx;
      if constexpr (kKind == K_I32) {
        mn = 0x7fffffff;
        mx = -0x7fffffff - 1;
      } else {
        mn = 0x7fffffffffffffffLL;
        mx = -0x7fffffffffffffffLL - 1;
      }
      long long isum = 0;
      int count = 0;
      double dsum = 0.0;
#pragma unroll
      for (int i = 0; i < kUnit; ++i) {
        if (byte_at(ok, i) == 0) continue;
        Int x;
        if constexpr (kKind == K_I32) {
          x = static_cast<int>(lane_word(value[i >> 2], i & 3));
        } else {
          x = static_cast<long long>(u64_at(value, i));
        }
        mn = x < mn ? x : mn;
        mx = x > mx ? x : mx;
        ++count;
        if constexpr (kKind == K_I32 && kMode == M_NONE) {
          isum += x;
        } else {
          dsum = __dadd_rn(dsum, value_of<kKind, kMode>(
                                     a, static_cast<unsigned long long>(x), 0,
                                     false, 0, sf, f));
        }
      }
      if (count == 0) return;
      if constexpr (kKind == K_I32 && kMode == M_NONE)
        dsum = __ll2double_rn(isum);
      merge(acc, dsum, count,
            order_key(value_of<kKind, kMode>(
                a, static_cast<unsigned long long>(mn), 0, false, 0, sf, f)),
            order_key(value_of<kKind, kMode>(
                a, static_cast<unsigned long long>(mx), 0, false, 0, sf, f)));
      return;
    }
#pragma unroll
    for (int i = 0; i < kUnit; ++i) {
      if (byte_at(ok, i) == 0) continue;
      unsigned long long x, l = 0;
      bool n = false;
      long long d = 0;
      if constexpr (kKind == K_I32) {
        x = static_cast<unsigned long long>(i32_at(value, i));
      } else {
        x = u64_at(value, i);
      }
      if constexpr (kKind == K_WIDE) {
        l = u64_at(lo, i);
        n = byte_at(neg, i) != 0;
      }
      if constexpr (kMode == M_DOTS) d = i32_at(dots, i);
      add(acc, value_of<kKind, kMode>(a, x, l, n, d, sf, f));
    }
  }
};

// A unit that is not full or not aligned, row by row. (Inline: as a
// call it gave every launch a stack frame, which cost device time at
// every launch on the H100, even when no row took it.)
template <int kKind, int kMode>
__device__ __forceinline__ Acc reduce_rows(const Agg& a, int64_t col,
                                           int64_t r0, int cnt) {
  const int32_t* d = a.desc + col * D_FIELDS;
  const Rows<kKind, kMode> r(a, d, r0);
  const int sf = kMode == M_DIGITS ? __ldg(d + D_SF) : 0;
  const double f = kMode == M_CONST ? __ldg(a.factor + col) : 1.0;
  Acc acc = empty_acc();
  for (int i = 0; i < cnt; ++i) {
    if (__ldg(r.ok + i) == 0) continue;
    unsigned long long x, l = 0;
    bool n = false;
    long long dots = 0;
    if constexpr (kKind == K_I32) {
      x = static_cast<unsigned long long>(static_cast<long long>(
          __ldg(static_cast<const int32_t*>(r.value) + i)));
    } else {
      x = static_cast<unsigned long long>(
          __ldg(static_cast<const int64_t*>(r.value) + i));
    }
    if constexpr (kKind == K_WIDE) {
      l = static_cast<unsigned long long>(__ldg(r.lo + i));
      n = __ldg(r.neg + i) != 0;
    }
    if constexpr (kMode == M_DOTS) dots = __ldg(r.dots + i);
    add(acc, value_of<kKind, kMode>(a, x, l, n, dots, sf, f));
  }
  return acc;
}

// Units [k0, k1) of one run (unit k: column col0 + k / units, rows from
// 16 * (k % units)) into this thread's acc: unit k0 + threadIdx.x, then
// every kThreads-th; kInFlight whole units are loaded before any of them
// is reduced.
template <int kKind, int kMode>
__device__ __forceinline__ void walk_run(const Agg& a, int64_t col0,
                                         int64_t k0, int64_t k1,
                                         const Split& s, Acc& acc) {
  constexpr int kInFlight = kKind == K_I32 ? 2 : 1;
  // 32-bit division where the unit numbers allow it
  const bool narrow = k1 <= 0xffffffffLL;
  for (int64_t k = k0 + threadIdx.x; k < k1;
       k += static_cast<int64_t>(kInFlight) * kThreads) {
    Unit<kKind, kMode> u[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int64_t kk = k + static_cast<int64_t>(j) * kThreads;
      u[j].full = false;
      if (kk < k1) {
        const int64_t q =
            narrow ? static_cast<int64_t>(static_cast<uint32_t>(kk) /
                                          static_cast<uint32_t>(s.units))
                   : kk / s.units;
        const int64_t c = col0 + q;
        const int64_t r0 = (kk - q * s.units) * kUnit;
        const int64_t left = s.live - r0;
        const int32_t* d = a.desc + c * D_FIELDS;
        const Rows<kKind, kMode> r(a, d, r0);
        if (left >= kUnit && r.aligned()) {
          u[j].load(r, kMode == M_DIGITS ? __ldg(d + D_SF) : 0,
                    kMode == M_CONST ? __ldg(a.factor + c) : 1.0);
        } else {
          const Acc t = reduce_rows<kKind, kMode>(
              a, c, r0, left < kUnit ? static_cast<int>(left) : kUnit);
          merge(acc, t.sum, t.count, t.lo, t.hi);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      if (u[j].full) u[j].reduce(a, acc);
  }
}

// Block-wide combine of every thread's acc into partial slot `slot`,
// in a fixed order (warp shuffles, then the warps in turn). Every thread
// of the block calls it.
__device__ void flush(const Agg& a, int64_t slot, Acc acc) {
  __shared__ double s_sum[kWarps];
  __shared__ int s_count[kWarps];
  __shared__ long long s_lo[kWarps], s_hi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const double sum = __shfl_down_sync(0xffffffffu, acc.sum, d);
    const int count = __shfl_down_sync(0xffffffffu, acc.count, d);
    const long long lo = __shfl_down_sync(0xffffffffu, acc.lo, d);
    const long long hi = __shfl_down_sync(0xffffffffu, acc.hi, d);
    merge(acc, sum, count, lo, hi);
  }
  if (lane == 0) {
    s_sum[warp] = acc.sum;
    s_count[warp] = acc.count;
    s_lo[warp] = acc.lo;
    s_hi[warp] = acc.hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc t = {s_sum[0], s_count[0], s_lo[0], s_hi[0]};
    for (int w = 1; w < kWarps; ++w)
      merge(t, s_sum[w], s_count[w], s_lo[w], s_hi[w]);
    a.partials[slot] = Partial{t.sum, t.lo, t.hi, t.count, 0};
  }
  __syncthreads();  // the shared slots are free for the next flush
}

// One field's partials into its outputs, by one warp: its runs in class
// order, each run's partials (the blocks whose shares meet the run's
// stretch of its class's line) lane by lane in block order, then a fixed
// shuffle tree. Partials are read past L1 (written by other blocks).
__device__ void combine_field(const Agg& a, int64_t fi, int lane) {
  Acc acc = empty_acc();
  int64_t field = -1;
  for (int64_t p = a.field_ptr[fi]; p < a.field_ptr[fi + 1]; ++p) {
    const int64_t r = a.field_runs[p];
    const int64_t* run = a.runs + r * R_FIELDS;
    const int cls = static_cast<int>(run[R_CLASS]);
    const int64_t* c = a.classes + cls * C_FIELDS;
    field = run[R_FIELD];
    const Split s = split_of(a, c[C_ROW_BYTES], a.grid[cls]);
    if (s.total == 0) continue;
    const int64_t start = run[R_START] * s.units;
    const int64_t end =
        (run[R_START] + (run[R_COL1] - run[R_COL0]) * c[C_WEIGHT]) * s.units;
    const int64_t b0 = block_of(s, start), b1 = block_of(s, end - 1);
    const Partial* part = a.partials + a.slot0[cls] + r;
    for (int64_t b = b0 + lane; b <= b1; b += 32)
      merge(acc, __ldcg(&part[b].sum), __ldcg(&part[b].count),
            __ldcg(&part[b].lo), __ldcg(&part[b].hi));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const double sum = __shfl_down_sync(0xffffffffu, acc.sum, d);
    const int count = __shfl_down_sync(0xffffffffu, acc.count, d);
    const long long lo = __shfl_down_sync(0xffffffffu, acc.lo, d);
    const long long hi = __shfl_down_sync(0xffffffffu, acc.hi, d);
    merge(acc, sum, count, lo, hi);
  }
  if (lane == 0 && field >= 0) {
    a.sums[field] = __dadd_rn(a.sums[field], acc.sum);
    a.counts[field] += acc.count;
    a.mins[field] = acc.lo < a.mins[field] ? acc.lo : a.mins[field];
    a.maxs[field] = acc.hi > a.maxs[field] ? acc.hi : a.maxs[field];
  }
}

// Block b's share of class `cls` (kind kKind, mode kMode): run by run,
// one partial a run the share meets.
template <int kKind, int kMode>
__device__ __forceinline__ void class_share(const Agg& a, int cls) {
  const int64_t* c = a.classes + cls * C_FIELDS;
  const int64_t weight = c[C_WEIGHT];
  const int64_t run0 = c[C_RUN0], run1 = c[C_RUN1];
  const Split s = split_of(a, c[C_ROW_BYTES], a.grid[cls]);
  const int64_t b = blockIdx.x;
  if (b >= s.blocks) return;
  const int64_t w0 = share_start(s, b), w1 = share_start(s, b + 1);
  // the run holding position w0: the last one starting at or before it
  int64_t lo = run0, hi = run1 - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (a.runs[mid * R_FIELDS + R_START] * s.units <= w0) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  for (int64_t r = lo; r < run1; ++r) {
    const int64_t* run = a.runs + r * R_FIELDS;
    const int64_t base = run[R_START] * s.units;
    if (base >= w1) break;
    // the run's units that start in [w0, w1)
    const int64_t col0 = run[R_COL0];
    const int64_t units = (run[R_COL1] - col0) * s.units;
    const int64_t k0 = w0 > base ? (w0 - base + weight - 1) / weight : 0;
    int64_t k1 = (w1 - base + weight - 1) / weight;
    k1 = k1 < units ? k1 : units;
    Acc acc = empty_acc();
    walk_run<kKind, kMode>(a, col0, k0, k1, s, acc);
    flush(a, a.slot0[cls] + r + b, acc);
  }
}

// One class (kind kKind, mode kMode) a launch: a kernel a class gets
// registers of its own, so the int32 kernel of the query's shapes keeps
// none for the PIC P, dot-scale, int64 or wide arithmetic (with the four
// int32 modes in one kernel it took 128 registers, spilled, and ran
// slower on the H100).
template <int kKind, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    aggregate_class(const Agg a, int cls) {
  // the next grid (a class, or the combine) may be scheduled now
  asm volatile("griddepcontrol.launch_dependents;");
  class_share<kKind, kMode>(a, cls);
  // a grid launched behind another ends after it, so that the combine's
  // wait covers every class (a no-op for the first)
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The combine: a warp a field, after every class's grid.
__global__ void __launch_bounds__(kThreads) combine_fields(const Agg a) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int64_t fi = static_cast<int64_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
  if (fi < a.n_out) combine_field(a, fi, threadIdx.x & 31);
}

using ClassKernel = void (*)(const Agg, int);

// the template instance of each (kind, mode): class_kernels[kind * 4 + mode]
const ClassKernel class_kernels[kClasses] = {
    aggregate_class<K_I32, M_NONE>,  aggregate_class<K_I32, M_CONST>,
    aggregate_class<K_I32, M_DOTS>,  aggregate_class<K_I32, M_DIGITS>,
    aggregate_class<K_I64, M_NONE>,  aggregate_class<K_I64, M_CONST>,
    aggregate_class<K_I64, M_DOTS>,  aggregate_class<K_I64, M_DIGITS>,
    aggregate_class<K_WIDE, M_NONE>, aggregate_class<K_WIDE, M_CONST>,
    aggregate_class<K_WIDE, M_DOTS>, aggregate_class<K_WIDE, M_DIGITS>};

// a launch on `s`, behind the grid before it when `behind` (programmatic
// dependent launch: it may start before that grid ends)
template <typename... Args>
cudaError_t launch(void (*kernel)(Args...), unsigned grid, cudaStream_t s,
                   bool behind, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = behind ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The grid of each (kind, mode) class on the current device, at
// out[kind * 4 + mode]: as many blocks of its kernel as fit on every SM
// at once.
extern "C" int cobrix_aggregate_grids(int32_t* out) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  for (int k = 0; k < kClasses && e == cudaSuccess; ++k) {
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, class_kernels[k], kThreads, 0);
    out[k] = blocks * sms;
  }
  return static_cast<int>(e);
}

// Adds each field's sum, count and min and max keys over the planes to
// sums / counts / mins / maxs (initialised by the wrapper). desc is
// [ncols, D_FIELDS] int32 and factor [ncols] float64, sorted by kind,
// mode and field; classes [n_classes, C_FIELDS] (on the device, and
// classes_host on the host), runs [n_runs, R_FIELDS], field_ptr [n_out +
// 1] and field_runs [n_runs] int64 (ops/aggregate.py AggregateSpec);
// grids the 12 grids of cobrix_aggregate_grids; partials scratch of the
// classes' (grid - 1) and n_runs slots of 32 bytes. The live row count is
// *n_dev when n_dev is not null, else n_host. One launch a class and one
// to combine, on `stream`.
extern "C" int cobrix_aggregate(
    const void* i32, const void* i64, const void* bools, int64_t N,
    const void* desc, const void* factor, const void* pow10,
    int32_t pow10_size, const void* classes, const int64_t* classes_host,
    int32_t n_classes, const void* runs, const void* field_ptr,
    const void* field_runs, int32_t n_out, const void* n_dev, int64_t n_host,
    const int32_t* grids, void* partials, void* sums, void* counts,
    void* mins, void* maxs, void* stream) {
  if (n_classes <= 0 || n_out <= 0 || N <= 0) return 0;
  if (n_classes > kClasses) return static_cast<int>(cudaErrorInvalidValue);
  Agg a{};
  a.i32 = static_cast<const int32_t*>(i32);
  a.i64 = static_cast<const int64_t*>(i64);
  a.bools = static_cast<const uint8_t*>(bools);
  a.N = N;
  a.desc = static_cast<const int32_t*>(desc);
  a.factor = static_cast<const double*>(factor);
  a.pow10 = static_cast<const double*>(pow10);
  a.pow10_size = pow10_size;
  a.classes = static_cast<const int64_t*>(classes);
  a.runs = static_cast<const int64_t*>(runs);
  a.field_ptr = static_cast<const int64_t*>(field_ptr);
  a.field_runs = static_cast<const int64_t*>(field_runs);
  a.n_out = n_out;
  a.n_dev = static_cast<const int32_t*>(n_dev);
  a.n_host = n_host;
  a.partials = static_cast<Partial*>(partials);
  a.sums = static_cast<double*>(sums);
  a.counts = static_cast<int32_t*>(counts);
  a.mins = static_cast<long long*>(mins);
  a.maxs = static_cast<long long*>(maxs);
  int64_t slot = 0;
  for (int c = 0; c < n_classes; ++c) {
    const int64_t* row = classes_host + c * C_FIELDS;
    const int64_t k = row[C_KIND] * 4 + row[C_MODE];
    if (k < 0 || k >= kClasses || grids[k] <= 0 ||
        (c > 0 && k <= classes_host[(c - 1) * C_FIELDS + C_KIND] * 4 +
                           classes_host[(c - 1) * C_FIELDS + C_MODE]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.grid[c] = grids[k];
    a.slot0[c] = slot - row[C_RUN0];
    slot += grids[k] - 1 + row[C_RUN1] - row[C_RUN0];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a launch a class. The first waits for the work before it on the
  // stream (the planes' decode); the others, and the combine, may start
  // behind the one before.
  for (int c = 0; c < n_classes; ++c) {
    const int64_t* row = classes_host + c * C_FIELDS;
    const cudaError_t e =
        launch(class_kernels[row[C_KIND] * 4 + row[C_MODE]],
               static_cast<unsigned>(a.grid[c]), s, c > 0, a, c);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(launch(
      combine_fields, static_cast<unsigned>((n_out + kWarps - 1) / kWarps), s,
      true, a));
}
