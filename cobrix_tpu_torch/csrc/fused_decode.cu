// Fused numeric decode for Hopper (sm_90a).
//
// Replaces the TPU kernel cobrix_tpu/ops/pallas_tpu.py::_fused_kernel
// (launched by build_fused_decode, assembled by _assemble_group): ONE
// launch decodes every fused numeric column of a record batch -- binary
// two's complement (COMP, 1-16 bytes), packed BCD (COMP-3) and zoned
// DISPLAY (EBCDIC and ASCII: overpunch, separate sign, '.'/',' point,
// space rules, and the digits-right-of-point plane) -- into the exact
// tuples the JAX package's _run_group_jax returns, dtype for dtype:
//   (int32 values, bool valid)                       i32 groups
//   (int64 values, bool valid)                       i64 groups
//   (uint64 hi, uint64 lo, bool negative, bool valid) wide groups
//   plus a trailing int32 dots plane for DISPLAY groups.
// hi/lo are stored as int64 bit patterns; the host views them as uint64.
// No byte planes and no limbs, unlike the TPU version: values accumulate
// in uint64 / unsigned __int128 and the final tuple is written directly.
//
// What bounds it. The least time is the bytes it must move over device
// memory (exp1: 1,457 field bytes in and 1,824 bytes out per record)
// with a few integer operations per byte. A thread per (record, column)
// cell that loads its field a byte at a time from the [n, row_len]
// matrix is bound instead by load transactions: a warp of 32 records
// gathers from 32 rows a pitch apart, 32 sectors for 32 useful bytes,
// once per field byte. This design reads each record byte from device
// memory once, coalesced; what is left is the decode's own instruction
// stream.
//
// The design:
// * Tile and window. A work item is a tile of kTile = 32 records by one
//   window [lo, lo + span) of the row. The window table is planned on the
//   host (ops/fused_decode.py::plan_windows): columns sorted by offset,
//   no field split, each staged tile within 48 KB, cut greedily. exp1's
//   1,493-byte row is one window; exp3's 16,064-byte row is 11.
// * Staging. The block copies the item's bytes into shared memory with
//   16-byte cp.async.cg copies: warp y takes records y, y + 16, ..., its
//   lanes consecutive chunks of the record, so a warp reads 512
//   contiguous bytes at a time. Record r's window lands at its own
//   16-byte phase in a row of `pitch` bytes.
// * Decode. A warp is the 32 records of the tile on one column at a time
//   (warp y takes the window's columns y, y + 16, ...): the descriptor
//   load is a broadcast, the kind switch never diverges, and stores into
//   the [col][record] planes are contiguous per warp. A field is read a
//   4-byte word at a time (Field::word: two shared loads and a funnel
//   shift). The decoders compute the functions of the byte loops of
//   pallas_tpu, bit for bit, with fewer instructions: binary assembles
//   whole words, BCD takes a byte's two digits at once
//   (acc * 100 + 10 hi + lo) and checks 8 nibbles at a time, DISPLAY runs
//   the per-byte rules over whole words (bytes past the field read 0, a
//   space, which changes no count), and i32 planes accumulate in 32 bits
//   (only the low 32 bits are stored).
// * Ring and persistent grid. Two 512-thread blocks per SM (the 64
//   registers and 2 x 2 stages that fit) walk the items in a stride; a
//   two-stage ring keeps the next item's copies in flight
//   (cp.async.commit_group / wait_group 1) while the current one
//   decodes. There is no grid.y and no cap on records.
//
// Traps, and what is done about each:
// * Alignment. 16-byte copies need 16-byte-aligned source and
//   destination. exp1's row is odd, so records start at any phase, and
//   the caller may pass a slice such as x[1:] whose data_ptr() is not
//   aligned. Each record's window is copied as the aligned chunks that
//   cover it; a chunk that would reach before data_ptr() or past
//   data_ptr() + n * row_len is copied byte by byte, zero outside. The
//   shared row keeps the global phase, so the copy needs no shifting.
// * Bank conflicts. exp3's pitch, 16,064 B, is a multiple of 128: rows at
//   their natural pitch would put a warp's 32 records in one bank. The
//   staged pitch is an odd number of 16-byte chunks (staged_pitch), so 8
//   records at one window position sit in 8 different 16-byte bank
//   slots. Rows that start 16-byte aligned cannot do better for 4-byte
//   reads: at exp3, where every record has the same phase, a word read
//   is 4-way conflicted (rows 8 apart share a bank). exp1's records have
//   differing phases and spread further.
// * Ragged edges. The last tile is short: its missing records are neither
//   copied nor decoded. A field byte at or past row_len reads 0
//   (Field::keep), as the TPU wrapper's zero pad, whatever the staged
//   chunk holds there. A field's word reads run up to 11 bytes past it;
//   16 bytes of slack after the stages keep the last record's inside the
//   allocation.
// * Registers. The u128 paths share one kernel; __launch_bounds__(512, 2)
//   holds it to 64 registers. The build prints -Xptxas -v (chip_smoke.py
//   phase 0); spills are 0.
//
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned __int128 u128;

constexpr int kTile = 32;      // records per item: one per lane
constexpr int kColSlots = 16;  // warps per block, each on its own columns
constexpr int kThreads = kTile * kColSlots;
constexpr int kStages = 2;
constexpr int kBlocksPerSM = 2;  // two 512-thread blocks: 64 registers each

// descriptor fields, kDescFields int32 per column (ops/fused_decode.py)
constexpr int kDescFields = 12;
enum Kind { K_BINARY = 0, K_BCD = 1, K_DISPLAY_EBCDIC = 2, K_DISPLAY_ASCII = 3 };
enum Out { O_I32 = 0, O_I64 = 1, O_WIDE = 2 };
enum Flag { F_SIGNED = 1, F_BIG_ENDIAN = 2, F_ALLOW_DOT = 4,
            F_REQUIRE_DIGITS = 8 };
// window table fields (ops/fused_decode.py::plan_windows)
constexpr int kWinFields = 5;
enum WinField { W_LO = 0, W_SPAN, W_PITCH, W_BEGIN, W_END };

struct Col {
  int offset, kind, out, width, flags, dyn_sf;  // offset: window-relative
  int value_row, lo_row, neg_row, valid_row, dots_row;
};

struct Planes {
  int32_t* o32;
  int64_t* o64;
  bool* ob;
  int64_t n;  // records: the row stride of every plane
};

struct Job {
  uintptr_t begin, end;  // the record matrix's bytes
  int64_t n_rows, row_len, n_tiles;
  const int32_t* desc;   // columns in window order
  const int32_t* win;
  int n_win, stage_chunks;
  Planes o;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// the low n bytes of a word, n clamped to 0..4
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return __funnelshift_lc(~0u, 0u, 8 * max(n, 0));
}

// One staged field, read a 4-byte word at a time: word(i) holds field
// bytes 4i..4i+3, byte 4i+b in bits 8b..8b+7. A byte at or past the row
// end reads 0, whatever the staged chunk holds there.
struct Field {
  uint32_t base;  // shared address of the aligned word holding byte 0
  uint32_t sh;    // bit offset of byte 0 in that word
  int keep;       // field bytes before the row end
  __device__ __forceinline__ uint32_t word(int i) const {
    const uint32_t a = base + 4u * i;
    return __funnelshift_r(lds32(a), lds32(a + 4), sh) &
           low_bytes(keep - 4 * i);
  }
};

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int b) {
  return (w >> (8 * b)) & 0xFFu;
}

// The accumulator of each value plane: i32 values are stored as their
// low 32 bits, so 32-bit arithmetic gives the same bits as 64-bit
template <int kOut> struct AccOf { typedef uint32_t T; };
template <> struct AccOf<O_I64> { typedef uint64_t T; };
template <> struct AccOf<O_WIDE> { typedef u128 T; };

__device__ __forceinline__ void put_wide(const Col& c, const Planes& o,
                                         int64_t r, u128 mag, bool neg,
                                         bool valid) {
  o.o64[c.value_row * o.n + r] = static_cast<int64_t>(
      static_cast<uint64_t>(mag >> 64));
  o.o64[c.lo_row * o.n + r] = static_cast<int64_t>(static_cast<uint64_t>(mag));
  o.ob[c.neg_row * o.n + r] = neg;
  o.ob[c.valid_row * o.n + r] = valid;
}

// a signed magnitude of the i32/i64 planes, or of the wide planes
template <int kOut, typename Acc>
__device__ __forceinline__ void put_value(const Col& c, const Planes& o,
                                          int64_t r, Acc mag, bool neg,
                                          bool valid) {
  if constexpr (kOut == O_WIDE) {
    put_wide(c, o, r, valid ? mag : u128(0), neg && valid, valid);
  } else {
    const Acc v = valid ? (neg ? Acc(0) - mag : mag) : Acc(0);
    if constexpr (kOut == O_I32)
      o.o32[c.value_row * o.n + r] = static_cast<int32_t>(v);
    else
      o.o64[c.value_row * o.n + r] = static_cast<int64_t>(v);
    o.ob[c.valid_row * o.n + r] = valid;
  }
}

// binary two's complement: the bytes in order, sign-extended from the
// first when signed. Built from the words the accumulator holds (a field
// fills at least the last of them): big-endian from byte-reversed words,
// shifted past the bytes after the field; little-endian from the words
// high first, masked to the field.
template <int kOut>
__device__ void decode_binary(const Col& c, const Field& f, const Planes& o,
                              int64_t r) {
  typedef typename AccOf<kOut>::T Acc;
  constexpr int kWords = sizeof(Acc) / 4;
  const int w = c.width;
  const bool sgn = c.flags & F_SIGNED;
  Acc acc = 0;
  if (c.flags & F_BIG_ENDIAN) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      acc = (acc << 16 << 16) | __byte_perm(f.word(i), 0, 0x0123);
    acc >>= 32 * kWords - 8 * w;
  } else {
#pragma unroll
    for (int i = kWords - 1; i >= 0; --i)
      acc = (acc << 16 << 16) | f.word(i);
    if (8 * w < 32 * kWords) acc &= ~(~Acc(0) << (8 * w));
  }
  if (sgn && 8 * w < 32 * kWords && ((acc >> (8 * w - 1)) & 1))
    acc |= ~Acc(0) << (8 * w);
  if constexpr (kOut == O_I32) {
    const uint32_t a = static_cast<uint32_t>(acc);
    // unsigned 4-byte value with the top bit set exceeds the declared
    // precision bucket -> null
    const bool valid = sgn || w != 4 || (a >> 31) == 0;
    o.o32[c.value_row * o.n + r] = valid ? static_cast<int32_t>(a) : 0;
    o.ob[c.valid_row * o.n + r] = valid;
  } else if constexpr (kOut == O_I64) {
    const int64_t v = static_cast<int64_t>(acc);
    const bool valid = sgn || w != 8 || v >= 0;  // unsigned overflow -> null
    o.o64[c.value_row * o.n + r] = valid ? v : 0;
    o.ob[c.valid_row * o.n + r] = valid;
  } else {
    const bool neg = sgn && static_cast<int64_t>(
                               static_cast<uint64_t>(acc >> 64)) < 0;
    put_wide(c, o, r, neg ? u128(0) - acc : acc, neg, true);
  }
}

// one bit per nibble of x that is 10 or more (bit 3 and bit 2 or 1 set)
__device__ __forceinline__ uint32_t nibbles_ge10(uint32_t x) {
  return (x >> 3) & ((x >> 2) | (x >> 1)) & 0x11111111u;
}

// a byte's two digit nibbles as a number: 10 * hi + lo
__device__ __forceinline__ uint32_t digit_pair(uint32_t b) {
  return b - 6 * (b >> 4);
}

// packed BCD: every digit nibble below 10, sign nibble C, D or F. Every
// byte but the last holds two digits, acc = acc * 100 + (10 hi + lo),
// which is (acc * 10 + hi) * 10 + lo; the last holds a digit and the sign.
template <int kOut>
__device__ void decode_bcd(const Col& c, const Field& f, const Planes& o,
                           int64_t r) {
  typedef typename AccOf<kOut>::T Acc;
  const int pairs = c.width - 1;
  Acc acc = 0;
  uint32_t bad = 0;
  int i = 0;
  for (; 4 * i + 4 <= pairs; ++i) {
    const uint32_t x = f.word(i);
    bad |= nibbles_ge10(x);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = acc * 100 + digit_pair(byte_of(x, k));
  }
  const uint32_t x = f.word(i);  // the pairs left, then the last byte
  const int rest = pairs - 4 * i;
  const uint32_t last = (x >> (8 * rest)) & 0xFFu;
  bad |= nibbles_ge10(x & low_bytes(rest)) | (last >= 0xA0u);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Acc next = acc * 100 + digit_pair(byte_of(x, k));
    acc = k < rest ? next : acc;
  }
  acc = acc * 10 + (last >> 4);
  const uint32_t sign = last & 0x0Fu;
  const bool valid = !bad && (sign == 0xC || sign == 0xD || sign == 0xF);
  put_value<kOut>(c, o, r, acc, sign == 0xD, valid);
}

// zoned DISPLAY: the per-byte rules of StringDecoders.decodeEbcdicNumber /
// decodeAsciiNumber, as in pallas_tpu._decode_display. Bytes past the
// field read as 0, a space in both code pages, which changes no count, so
// whole words are decoded.
template <int kOut, bool kAscii>
__device__ void decode_display(const Col& c, const Field& f, const Planes& o,
                               int64_t r) {
  typedef typename AccOf<kOut>::T Acc;
  const int w = c.width;
  Acc acc = 0;
  int n_digits = 0, n_signs = 0, n_dots = 0, dots_right = 0;
  uint32_t seen_dot = 0, negative = 0, unknown = 0;
  // ASCII interior-space rule: a space with a digit or point on both
  // sides nulls the value
  uint32_t seen_meaningful = 0, pending_space = 0, interior = 0;
  for (int i = 0; 4 * i < w; ++i) {
    const uint32_t x = f.word(i) & low_bytes(w - 4 * i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = byte_of(x, k);
      uint32_t is_digit, is_dot, is_space, sign_mark, neg_mark, dv;
      if (kAscii) {
        is_digit = b - 0x30u <= 9u;
        dv = b - 0x30u;
        const uint32_t minus = b == 0x2Du, plus = b == 0x2Bu;
        is_dot = (b == 0x2Eu) | (b == 0x2Cu);
        is_space = b <= 0x20u;
        neg_mark = minus;
        sign_mark = minus | plus;
        const uint32_t meaningful = is_digit | is_dot;
        interior |= meaningful & pending_space;
        pending_space |= is_space & seen_meaningful;
        seen_meaningful |= meaningful;
      } else {
        const uint32_t small = (b & 0x0Fu) <= 9u;
        const uint32_t fz = (b >> 4 == 0xFu) & small;
        const uint32_t cz = (b >> 4 == 0xCu) & small;
        const uint32_t dz = (b >> 4 == 0xDu) & small;
        is_digit = fz | cz | dz;
        dv = b & 0x0Fu;
        const uint32_t minus = b == 0x60u, plus = b == 0x4Eu;
        is_dot = (b == 0x4Bu) | (b == 0x6Bu);
        is_space = (b == 0x40u) | (b == 0u);
        neg_mark = dz | minus;
        sign_mark = cz | dz | minus | plus;
      }
      unknown |= (is_digit | sign_mark | is_dot | is_space) ^ 1u;
      seen_dot |= is_dot;
      dots_right += is_digit & seen_dot;
      n_digits += is_digit;
      n_dots += is_dot;
      n_signs += sign_mark;
      negative |= neg_mark;
      const Acc next = acc * 10 + dv;
      acc = is_digit ? next : acc;
    }
  }
  bool valid = !unknown && n_signs <= 1 && !interior;
  if (c.flags & F_REQUIRE_DIGITS) valid &= n_digits >= 1;
  valid &= (c.flags & F_ALLOW_DOT) ? n_dots <= 1 : n_dots == 0;
  if (!(c.flags & F_SIGNED)) valid &= !negative;
  o.o32[c.dots_row * o.n + r] =
      valid ? (c.dyn_sf >= 0 ? dots_right : -c.dyn_sf + n_digits) : 0;
  put_value<kOut>(c, o, r, acc, negative, valid);
}

template <int kOut>
__device__ __forceinline__ void decode_cell(const Col& c, const Field& f,
                                            const Planes& o, int64_t r) {
  switch (c.kind) {
    case K_BINARY: decode_binary<kOut>(c, f, o, r); break;
    case K_BCD: decode_bcd<kOut>(c, f, o, r); break;
    case K_DISPLAY_EBCDIC: decode_display<kOut, false>(c, f, o, r); break;
    default: decode_display<kOut, true>(c, f, o, r); break;
  }
}

// Issue the copies of one item's tile x window into `buf` (uncommitted):
// warp y takes records y, y + 16, ..., its lanes consecutive chunks.
__device__ void stage_item(const Job& j, int64_t tile, int win, uint4* buf) {
  const int32_t* wd = j.win + win * kWinFields;
  const int64_t r0 = tile * kTile;
  const int64_t lo = __ldg(wd + W_LO);
  const int per_row = (__ldg(wd + W_SPAN) + 30) / 16;  // chunks at any phase
  const int row_chunks = __ldg(wd + W_PITCH) / 16;
  const int rows = static_cast<int>(
      j.n_rows - r0 < kTile ? j.n_rows - r0 : kTile);
  for (int r = threadIdx.y; r < rows; r += kColSlots) {
    const uintptr_t first = j.begin + static_cast<uintptr_t>(
        (r0 + r) * j.row_len + lo);
    const uintptr_t row = first & ~uintptr_t(15);
    for (int c = threadIdx.x; c < per_row; c += kTile) {
      const uintptr_t src = row + 16u * c;
      uint4* dst = buf + r * row_chunks + c;
      if (src >= j.begin && src + 16 <= j.end) {
        cp_async16(smem_addr(dst), src);
      } else {  // a chunk that straddles the matrix's first or last byte
        uint8_t* d = reinterpret_cast<uint8_t*>(dst);
        for (int b = 0; b < 16; ++b) {
          const uintptr_t a = src + b;
          d[b] = (a >= j.begin && a < j.end)
                     ? __ldg(reinterpret_cast<const uint8_t*>(a)) : 0;
        }
      }
    }
  }
}

// Decode every column of one staged item: warp y takes the window's
// columns y, y + 16, ...
__device__ void decode_item(const Job& j, int64_t tile, int win,
                            const uint4* buf) {
  const int32_t* wd = j.win + win * kWinFields;
  const int64_t r = tile * kTile + threadIdx.x;
  if (r >= j.n_rows) return;
  const int64_t lo = __ldg(wd + W_LO);
  const int row_chunks = __ldg(wd + W_PITCH) / 16;
  const int end = __ldg(wd + W_END);
  const uint32_t phase = static_cast<uint32_t>(
      (j.begin + static_cast<uintptr_t>(r * j.row_len + lo)) & 15u);
  const uint32_t s = smem_addr(buf + threadIdx.x * row_chunks) + phase;
  const int64_t room = j.row_len - lo;
  const int lim = static_cast<int>(room < INT_MAX ? room : INT_MAX);
  for (int col = __ldg(wd + W_BEGIN) + threadIdx.y; col < end;
       col += kColSlots) {
    const int4* d = reinterpret_cast<const int4*>(
        j.desc + static_cast<int64_t>(col) * kDescFields);
    const int4 a = __ldg(d), b = __ldg(d + 1), e = __ldg(d + 2);
    const Col c{a.x - static_cast<int>(lo), a.y, a.z, a.w, b.x, b.y,
                b.z, b.w, e.x, e.y, e.z};
    const uint32_t at = s + static_cast<uint32_t>(c.offset);
    const Field f{at & ~3u, (at & 3u) * 8, lim - c.offset};
    if (c.out == O_I32) decode_cell<O_I32>(c, f, j.o, r);
    else if (c.out == O_I64) decode_cell<O_I64>(c, f, j.o, r);
    else decode_cell<O_WIDE>(c, f, j.o, r);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_decode_kernel(const Job j) {
  extern __shared__ uint4 stage[];
  // item = tile * n_win + win, walked in steps of gridDim.x
  const int64_t step_tiles = gridDim.x / j.n_win;
  const int step_win = gridDim.x % j.n_win;
  int64_t tile = blockIdx.x / j.n_win;
  int win = blockIdx.x % j.n_win;
  if (tile < j.n_tiles) stage_item(j, tile, win, stage);
  cp_async_commit();
  for (int k = 0; tile < j.n_tiles; ++k) {
    int64_t next_tile = tile + step_tiles;
    int next_win = win + step_win;
    if (next_win >= j.n_win) {
      next_win -= j.n_win;
      ++next_tile;
    }
    if (next_tile < j.n_tiles)
      stage_item(j, next_tile, next_win,
                 stage + ((k + 1) & 1) * j.stage_chunks);
    cp_async_commit();
    cp_async_wait<1>();  // this item's copies have landed (this thread's)
    __syncthreads();     // ... and every thread's
    decode_item(j, tile, win, stage + (k & 1) * j.stage_chunks);
    __syncthreads();     // the buffer is free for the item after next
    tile = next_tile;
    win = next_win;
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int cobrix_fused_decode(const void* data, int64_t n_rows,
                                   int64_t row_len, const void* desc,
                                   const void* windows, int32_t n_windows,
                                   int32_t max_pitch, void* o32, void* o64,
                                   void* ob, void* stream) {
  if (n_rows <= 0 || n_windows <= 0) return 0;
  // a field's word reads run up to 11 bytes past it: 16 bytes of slack
  // keep the last staged record's inside the allocation
  const int smem = kStages * kTile * max_pitch + 16;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_decode_kernel, kThreads, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave no stale error for the next launch
    return static_cast<int>(e);
  }
  const uintptr_t begin = reinterpret_cast<uintptr_t>(data);
  Job j{begin, begin + static_cast<uintptr_t>(n_rows * row_len), n_rows,
        row_len, (n_rows + kTile - 1) / kTile,
        static_cast<const int32_t*>(desc),
        static_cast<const int32_t*>(windows), n_windows,
        kTile * max_pitch / 16,
        Planes{static_cast<int32_t*>(o32), static_cast<int64_t*>(o64),
               static_cast<bool*>(ob), n_rows}};
  const int64_t items = j.n_tiles * n_windows;
  const int64_t slots = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(items < slots ? items : slots);
  fused_decode_kernel<<<blocks, dim3(kTile, kColSlots), smem,
                        static_cast<cudaStream_t>(stream)>>>(j);
  return static_cast<int>(cudaGetLastError());
}
