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
// sums differ from it only by the order of additions (atomics across
// blocks), min and max not at all.
//
// Output per field: a float64 sum, an int32 count, and min and max as
// order-preserving int64 keys of the double (bits, or bits ^ 0x7fff...
// for negative doubles), so that atomicMin / atomicMax on 64-bit integers
// combine the blocks; the wrapper decodes them on the host.
//
// Layout and what bounds it. The planes are column-major [rows, N]: a
// column's N values are contiguous, so a warp reads 32 neighbouring rows
// of one column in one transaction. A block takes a tile of consecutive
// descriptors (sorted by field on the host) and a chunk of rows; each
// thread walks its rows of each column, keeping a running sum, count and
// min and max keys in registers, and the block combines them (warp
// shuffles, then shared memory) only where the field changes, so a field
// of 2,000 OCCURS columns costs one atomic per block and statistic, not
// one per column. A thread issues the loads of four of its rows (flags,
// values, limbs and signs, dots) before it uses any of them, to keep
// several loads in flight. The function must read each value once (4 or 8 bytes,
// 16 for a wide value and its sign) and its valid flag (1 byte): it is
// bound by those bytes; the digit counts (at most 38 compares) and the
// power-of-ten lookups are a few integer operations a value.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows a thread loads before it uses them

// descriptor fields (ops/aggregate.py _DESC_FIELDS)
enum Desc { D_VALUE = 0, D_LO, D_NEG, D_VALID, D_DOTS, D_KIND, D_MODE, D_SF,
            D_FIELD, D_FIELDS };
enum Kind { K_I32 = 0, K_I64 = 1, K_WIDE = 2 };
enum Mode { M_NONE = 0, M_CONST = 1, M_DOTS = 2, M_DIGITS = 3 };

struct Agg {
  const int32_t* i32;
  const int64_t* i64;
  const uint8_t* bools;
  int64_t N;  // a plane row's length: the batch's (padded) rows
  const int32_t* desc;
  const double* factor;
  int64_t ncols;
  const double* pow10;  // pow10[k] = 10.0 ** -k
  int pow10_size;
  const int32_t* n_dev;  // live rows on the device, or null: n_host
  int64_t n_host;
  double* sums;
  int32_t* counts;
  long long* mins;
  long long* maxs;
  int cols_per_block;
  int64_t rows_per_block;
  int64_t row_chunks;
};

__device__ __forceinline__ long long order_key(double v) {
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
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

struct Acc {
  double sum;
  int count;
  long long lo, hi;  // min and max keys
};

// Block-wide combine of every thread's Acc; thread 0 adds it to the
// field's outputs. Every thread of the block calls it.
__device__ void flush(const Agg& a, int field, Acc acc) {
  __shared__ double s_sum[kWarps];
  __shared__ int s_count[kWarps];
  __shared__ long long s_lo[kWarps], s_hi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    acc.sum = __dadd_rn(acc.sum, __shfl_down_sync(0xffffffffu, acc.sum, d));
    acc.count += __shfl_down_sync(0xffffffffu, acc.count, d);
    const long long lo = __shfl_down_sync(0xffffffffu, acc.lo, d);
    const long long hi = __shfl_down_sync(0xffffffffu, acc.hi, d);
    acc.lo = lo < acc.lo ? lo : acc.lo;
    acc.hi = hi > acc.hi ? hi : acc.hi;
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
    for (int w = 1; w < kWarps; ++w) {
      t.sum = __dadd_rn(t.sum, s_sum[w]);
      t.count += s_count[w];
      t.lo = s_lo[w] < t.lo ? s_lo[w] : t.lo;
      t.hi = s_hi[w] > t.hi ? s_hi[w] : t.hi;
    }
    if (t.count > 0) {
      atomicAdd(a.sums + field, t.sum);
      atomicAdd(a.counts + field, t.count);
      atomicMin(a.mins + field, t.lo);
      atomicMax(a.maxs + field, t.hi);
    }
  }
  __syncthreads();  // the shared slots are free for the next flush
}

// One column's rows [r0, r1) of this thread into acc. The loads of
// kUnroll rows are issued before any of them is used, so that a thread
// keeps several loads in flight (a value's is not made to wait for its
// valid flag's).
template <int kKind>
__device__ __forceinline__ void walk_column(const Agg& a, const int32_t* d,
                                            double f, int64_t r0, int64_t r1,
                                            Acc& acc) {
  const int mode = d[D_MODE], sf = d[D_SF];
  const uint8_t* valid = a.bools + static_cast<int64_t>(d[D_VALID]) * a.N;
  const int64_t vrow = static_cast<int64_t>(d[D_VALUE]) * a.N;
  const int64_t lrow = static_cast<int64_t>(d[D_LO]) * a.N;
  const int64_t nrow = static_cast<int64_t>(d[D_NEG]) * a.N;
  const int64_t drow = static_cast<int64_t>(d[D_DOTS]) * a.N;
  for (int64_t base = r0 + threadIdx.x; base < r1;
       base += kUnroll * kThreads) {
    uint8_t ok[kUnroll], neg[kUnroll];
    long long x[kUnroll];
    unsigned long long lo[kUnroll];
    int dots[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = base + u * kThreads;
      const bool in = r < r1;
      ok[u] = in ? __ldg(valid + r) : 0;
      x[u] = !in ? 0
             : kKind == K_I32 ? static_cast<long long>(__ldg(a.i32 + vrow + r))
                              : static_cast<long long>(__ldg(a.i64 + vrow + r));
      lo[u] = (kKind == K_WIDE && in)
                  ? static_cast<unsigned long long>(__ldg(a.i64 + lrow + r)) : 0;
      neg[u] = (kKind == K_WIDE && in) ? __ldg(a.bools + nrow + r) : 0;
      dots[u] = (mode == M_DOTS && in) ? __ldg(a.i32 + drow + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      double v;
      int digits = 0;
      if (kKind == K_WIDE) {
        const unsigned long long hi = static_cast<unsigned long long>(x[u]);
        const double mag = __dadd_rn(
            __dmul_rn(__ull2double_rn(hi), 18446744073709551616.0),
            __ull2double_rn(lo[u]));
        v = neg[u] ? -mag : mag;
        if (mode == M_DIGITS) digits = digit_count_limbs(hi, lo[u]);
      } else {
        v = __ll2double_rn(x[u]);  // exact for int32 values
        if (mode == M_DIGITS) digits = digit_count(x[u]);
      }
      if (mode == M_CONST) {
        v = __dmul_rn(v, f);
      } else if (mode == M_DOTS) {
        v = __dmul_rn(v, pow10_neg(a, dots[u]));
      } else if (mode == M_DIGITS) {
        v = __dmul_rn(v, pow10_neg(a, static_cast<int64_t>(digits) - sf));
      }
      acc.sum = __dadd_rn(acc.sum, v);
      ++acc.count;
      const long long k = order_key(v);
      acc.lo = k < acc.lo ? k : acc.lo;
      acc.hi = k > acc.hi ? k : acc.hi;
    }
  }
}

__global__ void __launch_bounds__(kThreads) aggregate_columns(const Agg a) {
  const int64_t chunk = blockIdx.x % a.row_chunks;
  const int64_t tile = blockIdx.x / a.row_chunks;
  const int64_t c0 = tile * a.cols_per_block;
  const int64_t c1 = c0 + a.cols_per_block < a.ncols ? c0 + a.cols_per_block
                                                     : a.ncols;
  const int64_t n = a.n_dev != nullptr ? static_cast<int64_t>(*a.n_dev)
                                       : a.n_host;
  const int64_t live = n < a.N ? n : a.N;
  const int64_t r0 = chunk * a.rows_per_block;
  const int64_t r1 = r0 + a.rows_per_block < live ? r0 + a.rows_per_block
                                                  : live;
  if (r0 >= r1) return;  // the whole block: no row below n here
  const Acc empty = {0.0, 0, 0x7fffffffffffffffLL,
                     -0x7fffffffffffffffLL - 1};
  Acc acc = empty;
  for (int64_t c = c0; c < c1; ++c) {
    const int32_t* d = a.desc + c * D_FIELDS;
    const int field = d[D_FIELD];
    const double f = a.factor[c];
    switch (d[D_KIND]) {
      case K_I32: walk_column<K_I32>(a, d, f, r0, r1, acc); break;
      case K_I64: walk_column<K_I64>(a, d, f, r0, r1, acc); break;
      default: walk_column<K_WIDE>(a, d, f, r0, r1, acc); break;
    }
    if (c + 1 == c1 || a.desc[(c + 1) * D_FIELDS + D_FIELD] != field) {
      flush(a, field, acc);
      acc = empty;
    }
  }
}

}  // namespace

// Adds each field's sum, count and min and max keys over the planes to
// sums / counts / mins / maxs (initialised by the wrapper). desc is
// [ncols, D_FIELDS] int32 sorted by field, factor [ncols] float64. The
// live row count is *n_dev when n_dev is not null, else n_host. Blocks are
// tiles of cols_per_block descriptors x chunks of rows_per_block rows.
extern "C" int cobrix_aggregate(const void* i32, const void* i64,
                                const void* bools, int64_t N,
                                const void* desc, const void* factor,
                                int64_t ncols, const void* pow10,
                                int32_t pow10_size, const void* n_dev,
                                int64_t n_host, void* sums, void* counts,
                                void* mins, void* maxs,
                                int32_t cols_per_block, int64_t rows_per_block,
                                void* stream) {
  if (ncols <= 0 || N <= 0) return 0;
  if (cols_per_block <= 0 || rows_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (N + rows_per_block - 1) / rows_per_block;
  const int64_t tiles = (ncols + cols_per_block - 1) / cols_per_block;
  if (chunks * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Agg a{static_cast<const int32_t*>(i32),
              static_cast<const int64_t*>(i64),
              static_cast<const uint8_t*>(bools), N,
              static_cast<const int32_t*>(desc),
              static_cast<const double*>(factor), ncols,
              static_cast<const double*>(pow10), pow10_size,
              static_cast<const int32_t*>(n_dev), n_host,
              static_cast<double*>(sums), static_cast<int32_t*>(counts),
              static_cast<long long*>(mins), static_cast<long long*>(maxs),
              cols_per_block, rows_per_block, chunks};
  aggregate_columns<<<static_cast<unsigned>(chunks * tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
