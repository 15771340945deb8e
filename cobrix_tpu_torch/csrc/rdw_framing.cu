// RDW framing and record packing for Hopper (sm_90a).
//
// Replaces the device framing of cobrix_tpu/ops/device_framing.py, which
// the JAX package runs as XLA programs: `_scan_body` / `rdw_scan_device`
// (RDW record starts by pointer doubling) and `pack_records_device` (the
// zero-padded [n, extent] gather). The semantics are those of the host
// walk the JAX reader uses (native/framing.cpp rdw_scan and
// pack_records): both endiannesses, rdw_adjustment, the first-record
// file-header jump (done by the caller, which starts the scan past it),
// the footer's body end, the last length clamped to it, and a zero or
// oversized header reported at the position the sequential walk reaches.
//
// The scan works on one window of the file image, positions relative to
// the window (int32: a window is below 2 GiB). Every byte position p has
// a link, the position the header that WOULD start there leads to:
//   next(p) = p + 4 + length(p), clamped to the window's end L in the
// last window, or no link at all (p is a stop) for a zero, oversized or
// unreadable header, or, in a window that is not the last, a record that
// does not end inside it. Links advance by 5 bytes or more. The record
// starts are the chain start, next(start), ... up to L or the first stop.
// The window is cut into tiles of T positions (T a power of two, at most
// 65,536; ops/device_framing.py chooses it), and the chain is found in
// three passes that move O(L) bytes:
//   1. rdw_exits, a block per tile: the tile's bytes and a 3-byte halo
//      are copied into shared memory with 16-byte cp.async; each position
//      gets its link as a 16-bit tile-local index (itself where the link
//      leaves the tile or p is a stop), and pointer doubling in shared
//      memory takes every position to the last position of its chain
//      inside the tile. Whole-tile steps run until the positions a step
//      moved fit a work list (most links leave the tile within a few
//      hops); later steps take only those, until nothing moves. exits[p]
//      is that last position's link (at or past the tile's end) or, if
//      it is a stop, the stop itself (inside the tile). 4 bytes a
//      position are written once.
//   2. rdw_chain, one thread: from start, e = exits[e] until L or a stop;
//      each tile entered records its entry position (the others keep -1:
//      a long record can skip tiles). One dependent load a tile entered.
//      The stop, if any, gives the window's status as before: the chain
//      reached the window's end, stopped at a record that continues in
//      the next window (the caller starts the next window there), or
//      stopped at a zero or oversized header (the caller raises the JAX
//      package's FramingError at that position).
//   3. rdw_walk, a warp per tile entered, walks the chain from the entry
//      through a 4 KB window of the tile in shared memory. It runs twice:
//      once to count each tile's records (then one block turns the counts
//      into each tile's first output index and the window's record
//      count, which the caller reads back to size the outputs), once to
//      write each record's payload offset and length clamped to the
//      window.
//
// What bounds the scan. The function must read the headers on the chain
// and write 16 bytes a record. The passes read the window about three
// times and write and read 4 bytes a position in between (about 11 bytes
// a window byte), but what holds them is latency, not bytes: pass 2 is a
// chain of dependent loads, one a tile entered (so T is as large as the
// 16-bit local links allow), pass 3's walks are a chain of dependent
// shared-memory reads, one a record, and pass 1's doubling is bound by
// shared memory. The pointer doubling of the parent design read and
// wrote 8+ bytes a position in each of 27 whole-window steps.
//
// Pack: out[i, j] = image[offset_i + start_offset + j] for j below the
// record's remaining length (clamped to extent and to the image), else 0;
// a row whose offset is negative or past the image, or whose length is
// not positive, is all zero. The [n, extent] output is one flat byte
// stream whose base is 16-byte aligned, and every thread stores whole
// aligned 16-byte words of it, whatever the extent: a word may span rows.
// A block takes a tile of R rows, R * extent a multiple of 16, so tiles
// start and end on words (plan_pack_tiles in ops/device_framing.py). It
// walks the tile in chunks of K output words through a two-stage ring in
// shared memory: the rows a chunk touches are staged as the aligned
// 16-byte words that cover their bytes in the chunk (cp.async, the lanes
// of a row on neighbouring words; such a word holds a byte of the record
// and so cannot cross a page), while the chunk before is assembled: a
// word inside one row is two 16-byte runs of shared memory funnel-shifted
// together, a word across rows or past a record's end is assembled byte
// by byte. Row and column of a word come from counters stepped by
// constants divided out on the host, never a division per word. Only the
// last, partial word of the matrix is stored byte by byte. It reads each
// record byte from device memory about once (the staged words' edges and
// the rows shared by two chunks are read twice) and writes each output
// byte once: it is bound by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kMaxRdwRecordSize = 100LL * 1024 * 1024;  // native cap
constexpr int kExitThreads = 1024;  // pass 1 block (fewer for tiny tiles)
constexpr int kWalkWindow = 4096;   // pass 3: bytes of the tile a warp holds
constexpr int kPlanRows = 4;        // pack: rows a thread plans at once
constexpr int kScanThreads = 1024;  // the count scan's one block

enum ScanStatus : int64_t {
  kDone = 0,        // the chain reached the window's end
  kCarry = 1,       // stopped at a record that continues past the window
  kZero = -1,       // zero-length header at the stop position
  kTooBig = -2,     // oversized header at the stop position
};

// head[]: what the caller reads back after pass 3's count
enum Head { H_RECORDS = 0, H_CODE, H_AT, H_LENGTH, H_HOPS };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Scan {
  const uint8_t* img;
  int64_t L;
  int tile_log2;
  int big_endian, adjustment, last_window;
};

__device__ __forceinline__ int64_t header_length(const uint8_t* h,
                                                 int big_endian,
                                                 int adjustment) {
  const int64_t len = big_endian
      ? (int64_t)h[1] + 256 * (int64_t)h[0]
      : (int64_t)h[2] + 256 * (int64_t)h[3];
  return len + adjustment;
}

// next(p) from the header bytes h = image + p, or -1 where p is a stop
__device__ __forceinline__ int64_t link_at(const Scan& s, const uint8_t* h,
                                           int64_t p) {
  if (p + 4 > s.L) return -1;
  const int64_t len = header_length(h, s.big_endian, s.adjustment);
  if (len <= 0 || len > kMaxRdwRecordSize) return -1;
  const int64_t nxt = p + 4 + len;
  if (nxt > s.L) return s.last_window ? s.L : -1;
  return nxt;
}

// the bytes pass 1 stages: a tile, the halo and both ends' alignment
__host__ __device__ __forceinline__ int64_t tile_stage_size(int64_t T) {
  return (T + 3 + 30) / 16 * 16;
}

// Copies image[lo, hi) into dst as the aligned 16-byte words that cover
// it (each holds a byte of the range); returns lo's phase in dst.
__device__ __forceinline__ int stage_range(const uint8_t* img, int64_t lo,
                                           int64_t hi, uint8_t* dst) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(img + lo);
  const uintptr_t a0 = first & ~uintptr_t(15);
  const int words = static_cast<int>(
      (reinterpret_cast<uintptr_t>(img + hi) - a0 + 15) >> 4);
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    cp_async16(dst + 16 * w, a0 + 16u * w);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  return static_cast<int>(first & 15);
}

// Pass 1. Shared memory: T uint16 local links, the tile's bytes, then a
// work list of T / 4 positions.
__global__ void __launch_bounds__(kExitThreads)
rdw_exits(const Scan s, int32_t* __restrict__ exits,
          int32_t* __restrict__ entry) {
  extern __shared__ uint4 smem[];
  __shared__ int listed;
  const int64_t T = int64_t(1) << s.tile_log2;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) << s.tile_log2;
  const int n = static_cast<int>(s.L - t0 < T ? s.L - t0 : T);
  const int64_t t1 = t0 + n;
  volatile uint16_t* ex = reinterpret_cast<uint16_t*>(smem);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem) + 2 * T;
  uint16_t* list = reinterpret_cast<uint16_t*>(bytes + tile_stage_size(T));
  const int cap = static_cast<int>(T / 4);
  const int lane = threadIdx.x & 31;
  const int64_t hi = t1 + 3 < s.L ? t1 + 3 : s.L;  // the 3-byte halo
  const uint8_t* tb = bytes + stage_range(s.img, t0, hi, bytes);  // t0
  if (threadIdx.x == 0) entry[blockIdx.x] = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t nx = link_at(s, tb + i, t0 + i);
    ex[i] = static_cast<uint16_t>(nx < 0 || nx >= t1 ? i : nx - t0);
  }
  // Doubling in place: a link read after another thread moved it in the
  // same step is still on the chain, only further along, so each step at
  // least doubles the hops as in the double-buffered form. A position
  // that a step leaves unmoved points at the end of its chain for good:
  // once the positions a whole-tile step moved fit the work list, later
  // steps take only those (most links leave the tile within a few hops;
  // the records' own chains are what is left).
  bool use_list = false;
  int n_list = 0;
  for (;;) {
    if (threadIdx.x == 0) listed = 0;
    __syncthreads();
    int changed = 0;
    if (use_list) {
      for (int q = threadIdx.x; q < n_list; q += blockDim.x) {
        const int i = list[q];
        const int j = ex[i];
        const int k = ex[j];
        if (k != j) {
          ex[i] = static_cast<uint16_t>(k);
          changed = 1;
        }
      }
    } else {
      for (int b = threadIdx.x - lane; b < n; b += blockDim.x) {
        const int i = b + lane;
        bool moved = false;
        if (i < n) {
          const int j = ex[i];
          const int k = ex[j];
          if (k != j) {
            ex[i] = static_cast<uint16_t>(k);
            moved = true;
          }
        }
        const unsigned m = __ballot_sync(0xffffffffu, moved);
        if (m) {
          changed = 1;
          int at = 0;
          if (lane == 0) at = atomicAdd(&listed, __popc(m));
          at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1));
          if (moved && at < cap) list[at] = static_cast<uint16_t>(i);
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
    if (!use_list) {
      n_list = listed;
      use_list = n_list <= cap;
    }
    __syncthreads();  // every thread has read `listed` before it is reset
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = ex[i];
    const int64_t nx = link_at(s, tb + j, t0 + j);
    exits[t0 + i] = static_cast<int32_t>(nx < 0 ? t0 + j : nx);
  }
}

// Pass 2: the chain across tiles, and the window's status.
__global__ void rdw_chain(const Scan s, int64_t start,
                          const int32_t* __restrict__ exits,
                          int32_t* __restrict__ entry,
                          int64_t* __restrict__ head) {
  int64_t e = start, hops = 0, code = kDone, at = s.L, len = 0;
  while (e < s.L) {
    const int64_t k = e >> s.tile_log2;
    const int64_t next_tile = (k + 1) << s.tile_log2;
    const int64_t end = next_tile < s.L ? next_tile : s.L;
    entry[k] = static_cast<int32_t>(e);
    ++hops;
    const int64_t x = exits[e];
    if (x < end) {  // a stop inside the tile: the chain ends at x
      at = x;
      if (x + 4 <= s.L) {
        len = header_length(s.img + x, s.big_endian, s.adjustment);
        code = len <= 0 ? kZero : len > kMaxRdwRecordSize ? kTooBig : kCarry;
      } else {
        code = s.last_window ? kDone : kCarry;  // header cut by the window
      }
      break;
    }
    e = x;
  }
  head[H_CODE] = code;
  head[H_AT] = at;
  head[H_LENGTH] = len;
  head[H_HOPS] = hops;
}

// Pass 3: walk each entered tile's chain from its entry, a warp a tile.
// kWrite = false counts the tile's records into base[k]; kWrite = true
// writes them from base[k], which the scan below made the tile's first
// output index. The lanes walk together (their reads are one broadcast)
// through a 4 KB window of the tile in shared memory, which they reload
// with 16-byte cp.async from the walk's position when a header leaves it.
// The capped mode (build_wide_pipeline's): only the records whose header
// length (adjustment included, before the clamp to the window) is at
// least min_len count and are written, and a record whose output index
// is cap or more is not written. min_len = 0 and cap < 0 keep every
// record, as every header on the chain has a positive length.
template <bool kWrite>
__global__ void __launch_bounds__(32)
rdw_walk(const Scan s, const int32_t* __restrict__ entry,
         int32_t* __restrict__ base, int64_t* __restrict__ offsets,
         int64_t* __restrict__ lengths, int64_t min_len, int64_t cap) {
  __shared__ uint4 window[kWalkWindow / 16];
  uint8_t* held = reinterpret_cast<uint8_t*>(window);
  const int64_t e = entry[blockIdx.x];
  const int lane = threadIdx.x;
  if (e < 0) {
    if (!kWrite && lane == 0) base[blockIdx.x] = 0;
    return;
  }
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) << s.tile_log2;
  const int64_t t1 = t0 + (int64_t(1) << s.tile_log2) < s.L
                         ? t0 + (int64_t(1) << s.tile_log2) : s.L;
  const uintptr_t end = reinterpret_cast<uintptr_t>(s.img) +
                        (t1 + 3 < s.L ? t1 + 3 : s.L);
  int64_t w0 = 0, w1 = 0;  // the window holds image positions [w0, w1)
  int64_t out = kWrite ? base[blockIdx.x] : 0;
  for (int64_t p = e; p < t1;) {
    if (p + 4 <= s.L && p + 4 > w1) {
      const uintptr_t src = reinterpret_cast<uintptr_t>(s.img + p);
      const uintptr_t a0 = src & ~uintptr_t(15);
      const int64_t want = static_cast<int64_t>((end - a0 + 15) >> 4);
      const int words = static_cast<int>(
          want < kWalkWindow / 16 ? want : kWalkWindow / 16);
      __syncwarp();  // every lane is done with the old window
      for (int w = lane; w < words; w += 32) cp_async16(window + w, a0 + 16u * w);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      w0 = p - static_cast<int64_t>(src & 15);
      w1 = w0 + 16 * words;
    }
    const int64_t nx = link_at(s, held + (p - w0), p);
    if (nx < 0) break;
    if (min_len <= 0 ||
        header_length(held + (p - w0), s.big_endian, s.adjustment) >= min_len) {
      if (kWrite && cap >= 0 && out >= cap) break;  // the rest is dropped
      if (kWrite && lane == 0) {
        offsets[out] = p + 4;
        lengths[out] = nx - (p + 4);  // the header's length, clamped to L
      }
      ++out;
    }
    p = nx;
  }
  if (!kWrite && lane == 0) base[blockIdx.x] = static_cast<int32_t>(out);
}

// Exclusive scan of the tiles' counts in place, in one block; the total
// is the window's record count.
__global__ void __launch_bounds__(kScanThreads)
rdw_count_scan(int32_t* __restrict__ base, int64_t n_tiles,
               int64_t* __restrict__ head, int64_t cap,
               int32_t* __restrict__ live) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t b = 0; b < n_tiles; b += kScanThreads) {
    const int64_t k = b + threadIdx.x;
    const int32_t v = k < n_tiles ? base[k] : 0;
    int32_t x = v;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int64_t before = carry + (warp ? warp_sums[warp - 1] : 0) + x - v;
    if (k < n_tiles) base[k] = static_cast<int32_t>(before);
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    head[H_RECORDS] = carry;
    // the capped mode's live count, left on the device
    if (live != nullptr) *live = static_cast<int32_t>(carry < cap ? carry : cap);
  }
}

// ---------------------------------------------------------------------------
// pack
// ---------------------------------------------------------------------------

struct Pack {
  const uint8_t* img;
  int64_t size;
  const int64_t* offsets;
  const int64_t* lengths;
  int64_t n, start_offset;
  uint8_t* out;
  int extent;
  int rows;         // R: rows a tile
  int chunk_words;  // K: output words a chunk, a multiple of blockDim.x
  int slots;        // rows one chunk touches at most
  int slot_words;   // 16-byte words staged a row and chunk
  int lanes_log2;   // threads staging one row
  // 16 * K and 16 * blockDim.x as (rows, columns) of the extent
  int chunk_rows, chunk_cols, step_rows, step_cols;
};

struct Cursor {
  int row, col;
  __device__ __forceinline__ void advance(int rows, int cols, int extent) {
    row += rows;
    col += cols;
    if (col >= extent) {
      col -= extent;
      ++row;
    }
  }
};

// One staged row of a chunk: its column c (lo <= c < end) lies at byte
// bias + c of the stage; columns at or past `end` are zero. The copy is
// `words` aligned 16-byte words from `src`.
struct Slot {
  uintptr_t src;
  int bias, end, words, unused;
};

// A chunk's rows, a thread each; a thread loads the offsets and lengths
// of up to kPlanRows rows before it uses them, so narrow rows (a chunk
// touches hundreds) cost one round trip to memory, not several.
__device__ __forceinline__ void plan_slots(const Pack& p, int64_t r0,
                                           Cursor a, int nslots,
                                           int hi_last, Slot* slots) {
  for (int s0 = threadIdx.x; s0 < nslots; s0 += kPlanRows * blockDim.x) {
    int64_t offs[kPlanRows], lens[kPlanRows];
#pragma unroll
    for (int u = 0; u < kPlanRows; ++u) {
      const int s = s0 + u * blockDim.x;
      if (s < nslots) {
        offs[u] = __ldg(p.offsets + r0 + a.row + s);
        lens[u] = __ldg(p.lengths + r0 + a.row + s);
      }
    }
#pragma unroll
    for (int u = 0; u < kPlanRows; ++u) {
      const int s = s0 + u * blockDim.x;
      if (s >= nslots) break;
      const int lo = s == 0 ? a.col : 0;
      const int hi = s == nslots - 1 ? hi_last : p.extent;
      const int64_t off = offs[u] + p.start_offset;
      int64_t len = lens[u] - p.start_offset;
      if (len > p.extent) len = p.extent;
      if (off < 0 || len <= 0 || off >= p.size) {
        len = 0;
      } else if (off + len > p.size) {
        len = p.size - off;
      }
      const int end = static_cast<int>(len < hi ? len : hi);
      Slot slot{0, 0, 0, 0, 0};
      if (end > lo) {
        const uintptr_t src = reinterpret_cast<uintptr_t>(p.img + off + lo);
        const int phase = static_cast<int>(src & 15);
        slot = Slot{src & ~uintptr_t(15), s * p.slot_words * 16 + phase - lo,
                    end, (phase + (end - lo) + 15) >> 4, 0};
      }
      slots[s] = slot;
    }
  }
}

// Issue the copies of a chunk's planned rows, `lanes` threads a row on
// neighbouring words (uncommitted).
__device__ __forceinline__ void copy_slots(const Pack& p, int nslots,
                                           const Slot* slots, uint4* data) {
  const int lanes = 1 << p.lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  for (int s = threadIdx.x >> p.lanes_log2; s < nslots;
       s += blockDim.x >> p.lanes_log2) {
    const uintptr_t src = slots[s].src;
    const int words = slots[s].words;
    uint4* dst = data + s * p.slot_words;
    for (int w = lane; w < words; w += lanes) cp_async16(dst + w, src + 16u * w);
  }
}

__global__ void __launch_bounds__(256)
pack_tiles(const Pack p) {
  extern __shared__ uint4 smem[];
  const int E = p.extent;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * p.rows;
  const int rows = static_cast<int>(p.n - r0 < p.rows ? p.n - r0 : p.rows);
  const int64_t tile_bytes = static_cast<int64_t>(rows) * E;
  const int64_t tile_words = (tile_bytes + 15) >> 4;
  const int64_t K = p.chunk_words;
  const int64_t n_chunks = (tile_words + K - 1) / K;
  uint8_t* out = p.out + r0 * E;  // 16-byte aligned: R * E is
  // ring stage k: data at smem + k * stage_u4, row plans at plans + k * p.slots
  const int stage_u4 = p.slots * p.slot_words;
  Slot* plans = reinterpret_cast<Slot*>(smem + 2 * stage_u4);

  // the rows chunk c touches, from its first byte's cursor and the next
  // chunk's; the last chunk ends with the tile
  auto span = [&](int64_t c, Cursor a, int* nslots, int* hi_last) {
    if (c + 1 == n_chunks) {
      *nslots = rows - a.row;
      *hi_last = E;
      return;
    }
    Cursor b = a;
    b.advance(p.chunk_rows, p.chunk_cols, E);
    *nslots = b.row - a.row + (b.col > 0);
    *hi_last = b.col > 0 ? b.col : E;
  };

  Cursor staged{0, 0};  // first byte of the chunk being staged
  int nslots, hi_last;
  span(0, staged, &nslots, &hi_last);
  plan_slots(p, r0, staged, nslots, hi_last, plans);
  __syncthreads();
  copy_slots(p, nslots, plans, smem);
  cp_async_commit();
  // this thread's word: t, t + blockDim.x, ... of the tile
  Cursor w{static_cast<int>((16 * threadIdx.x) / E),
           static_cast<int>((16 * threadIdx.x) % E)};
  int64_t word = threadIdx.x;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const Cursor chunk = staged;
    if (c + 1 < n_chunks) {
      staged.advance(p.chunk_rows, p.chunk_cols, E);
      span(c + 1, staged, &nslots, &hi_last);
      const int next = static_cast<int>((c + 1) & 1);
      plan_slots(p, r0, staged, nslots, hi_last, plans + next * p.slots);
      __syncthreads();
      copy_slots(p, nslots, plans + next * p.slots, smem + next * stage_u4);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies have landed (this thread's)
    __syncthreads();     // ... and every thread's
    const int stage = static_cast<int>(c & 1);
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(smem + stage * stage_u4);
    const uint32_t* s32 =
        reinterpret_cast<const uint32_t*>(smem + stage * stage_u4);
    const Slot* m = plans + stage * p.slots;
    const int64_t last = (c + 1) * K < tile_words ? (c + 1) * K : tile_words;
    for (; word < last; word += blockDim.x) {
      const int slot = w.row - chunk.row;
      const int2 sm = make_int2(m[slot].bias, m[slot].end);
      uint32_t v[4] = {0, 0, 0, 0};
      const int64_t left = tile_bytes - 16 * word;
      if (w.col + 16 <= E && (w.col + 16 <= sm.y || w.col >= sm.y)) {
        if (w.col < sm.y) {  // 16 bytes of one record
          const int b = sm.x + w.col;
          const int a = b >> 2, sh = (b & 3) * 8;
          uint32_t x[5];
#pragma unroll
          for (int k = 0; k < 4; ++k) x[k] = s32[a + k];
          x[4] = sh ? s32[a + 4] : 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(x[k], x[k + 1], sh);
        }
      } else {  // across rows or a record's end: byte by byte
        int col = w.col, sl = slot;
        int2 mm = sm;
        const int lim = left < 16 ? static_cast<int>(left) : 16;
#pragma unroll
        for (int k = 0; k < 16; ++k) {  // unrolled: v stays in registers
          if (k < lim) {
            if (col < mm.y) v[k >> 2] |= uint32_t(sb[mm.x + col]) << (8 * (k & 3));
            if (++col == E) {
              col = 0;
              if (k + 1 < lim) {
                ++sl;
                mm = make_int2(m[sl].bias, m[sl].end);
              }
            }
          }
        }
      }
      uint8_t* dst = out + 16 * word;
      if (left >= 16) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {  // the matrix's last, partial word
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < left) dst[k] = (v[k >> 2] >> (8 * (k & 3))) & 0xff;
      }
      w.advance(p.step_rows, p.step_cols, E);
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }
}

// A launch that needs more than the default 48 KB of shared memory must
// be allowed it first; any error of that or of the launch is returned.
template <typename Kernel>
int allow_smem(Kernel k, int64_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

Scan make_scan(const void* img, int64_t L, int32_t tile_log2,
               int32_t big_endian, int32_t adjustment, int32_t last_window) {
  return Scan{static_cast<const uint8_t*>(img), L, tile_log2, big_endian,
              adjustment, last_window};
}

int64_t tiles_of(int64_t L, int32_t tile_log2) {
  return (L + (int64_t(1) << tile_log2) - 1) >> tile_log2;
}


}  // namespace

// Pass 1: exits (int32, L) and entry (int32 a tile, set to -1). The tile
// is 2^tile_log2 positions, 8 to 65,536.
extern "C" int cobrix_rdw_exits(const void* img, int64_t L, int32_t tile_log2,
                                int32_t big_endian, int32_t adjustment,
                                int32_t last_window, void* exits,
                                void* entry, void* stream) {
  const int64_t tiles = tiles_of(L, tile_log2);
  if (tiles == 0) return 0;
  const int64_t T = int64_t(1) << tile_log2;
  // links, the staged tile, the work list
  const int64_t smem = 2 * T + tile_stage_size(T) + 2 * (T / 4);
  const int threads = static_cast<int>(
      T < 32 ? 32 : T < kExitThreads ? T : kExitThreads);
  if (const int rc = allow_smem(rdw_exits, smem)) return rc;
  rdw_exits<<<static_cast<unsigned>(tiles), threads, smem,
              static_cast<cudaStream_t>(stream)>>>(
      make_scan(img, L, tile_log2, big_endian, adjustment, last_window),
      static_cast<int32_t*>(exits), static_cast<int32_t*>(entry));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: the chain from start (<= L); head[1..4] = status code, position,
// length, tiles entered.
extern "C" int cobrix_rdw_chain(const void* img, int64_t L, int64_t start,
                                int32_t tile_log2, int32_t big_endian,
                                int32_t adjustment, int32_t last_window,
                                const void* exits, void* entry, void* head,
                                void* stream) {
  rdw_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      make_scan(img, L, tile_log2, big_endian, adjustment, last_window),
      start, static_cast<const int32_t*>(exits),
      static_cast<int32_t*>(entry), static_cast<int64_t*>(head));
  return static_cast<int>(cudaGetLastError());
}

// Pass 3's count: base[k] = the first output index of tile k's records,
// head[0] = the window's record count. The capped mode counts only the
// records whose header length is at least min_len and, where live is not
// null, leaves min(count, cap) there as an int32 (min_len = 0, cap = -1,
// live = null: every record).
extern "C" int cobrix_rdw_count(const void* img, int64_t L, int32_t tile_log2,
                                int32_t big_endian, int32_t adjustment,
                                int32_t last_window, const void* entry,
                                void* base, void* head, int64_t min_len,
                                int64_t cap, void* live, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(L, tile_log2);
  if (tiles > 0) {
    rdw_walk<false><<<static_cast<unsigned>(tiles), 32, 0, st>>>(
        make_scan(img, L, tile_log2, big_endian, adjustment, last_window),
        static_cast<const int32_t*>(entry), static_cast<int32_t*>(base),
        nullptr, nullptr, min_len, cap);
    if (const int rc = static_cast<int>(cudaGetLastError())) return rc;
  }
  rdw_count_scan<<<1, kScanThreads, 0, st>>>(
      static_cast<int32_t*>(base), tiles, static_cast<int64_t*>(head), cap,
      static_cast<int32_t*>(live));
  return static_cast<int>(cudaGetLastError());
}

// Pass 3's records: payload offsets and lengths (int64, the count) of
// every record on the chain; the capped mode writes those whose header
// length is at least min_len, the first cap of them (cap < 0: all).
extern "C" int cobrix_rdw_records(const void* img, int64_t L,
                                  int32_t tile_log2, int32_t big_endian,
                                  int32_t adjustment, int32_t last_window,
                                  const void* entry, const void* base,
                                  void* offsets, void* lengths,
                                  int64_t min_len, int64_t cap,
                                  void* stream) {
  const int64_t tiles = tiles_of(L, tile_log2);
  if (tiles == 0) return 0;
  rdw_walk<true><<<static_cast<unsigned>(tiles), 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      make_scan(img, L, tile_log2, big_endian, adjustment, last_window),
      static_cast<const int32_t*>(entry),
      const_cast<int32_t*>(static_cast<const int32_t*>(base)),
      static_cast<int64_t*>(offsets), static_cast<int64_t*>(lengths),
      min_len, cap);
  return static_cast<int>(cudaGetLastError());
}

// Zero-padded [n, extent] uint8 matrix of the records (offset, length)
// of an image of `size` bytes, from start_offset into each record, by the
// tile plan of ops/device_framing.py::plan_pack_tiles. `out` is 16-byte
// aligned.
extern "C" int cobrix_pack_records(const void* img, int64_t size,
                                   const void* offsets, const void* lengths,
                                   int64_t n, int64_t extent,
                                   int64_t start_offset, void* out,
                                   int32_t rows, int64_t tiles,
                                   int32_t chunk_words, int32_t threads,
                                   int32_t slots, int32_t slot_words,
                                   int32_t lanes_log2, void* stream) {
  if (n <= 0 || extent <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0 || extent > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = 16 * static_cast<int64_t>(chunk_words);
  const int64_t step = 16 * static_cast<int64_t>(threads);
  const Pack p{static_cast<const uint8_t*>(img), size,
               static_cast<const int64_t*>(offsets),
               static_cast<const int64_t*>(lengths), n, start_offset,
               static_cast<uint8_t*>(out), static_cast<int>(extent), rows,
               chunk_words, slots, slot_words, lanes_log2,
               static_cast<int>(chunk / extent), static_cast<int>(chunk % extent),
               static_cast<int>(step / extent), static_cast<int>(step % extent)};
  const int64_t smem = 2 * static_cast<int64_t>(slots) *
                       (16 * static_cast<int64_t>(slot_words) + sizeof(Slot));
  if (const int rc = allow_smem(pack_tiles, smem)) return rc;
  pack_tiles<<<static_cast<unsigned>(tiles), threads, smem,
               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
