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
// the window (int32: a window is below 2 GiB). For every byte position p
// the link kernel decodes the header that WOULD start there:
//   next(p) = p + 4 + length(p), or the terminal L for an invalid header
// (zero, oversized, not readable, or in a window that is not the last, a
// record that does not end inside it). Record starts are the orbit of the
// start position under next; `rdw_double` extends the reachable set
// through next^(2^k) and squares the links, ceil(log2(L + 1)) times.
// The reachable flags only ever go from 0 to 1, so a step that reads a
// flag another thread already set in the same step reaches no position
// that is not on the chain: it only gets there sooner. The links are
// double-buffered (next^(2^(k+1)) = next^(2^k) o next^(2^k) needs the old
// table). `rdw_finish` marks starts (reachable and valid) and the last
// reachable position q; the caller compacts the starts (torch.nonzero)
// and `rdw_records` writes each record's payload offset and clamped
// length, and from q the window's status: the chain reached the window's
// end, stopped at a record that continues in the next window (the caller
// starts the next window there), or stopped at a zero or oversized header
// (the caller raises the JAX package's FramingError at that position).
//
// What bounds it. The link pass reads the window once; each doubling step
// reads and writes the link tables (8 bytes a position) and gathers
// through them, so the scan moves about 26 x 13 bytes per window byte for
// a 64 MiB window: it is bound by device memory traffic, O(n log n), not
// by arithmetic. The sequential walk it replaces is O(n) but one
// dependent load per record. Cutting the steps (a hop bound from the
// shortest record, or a block-local chain walk before the doubling) is
// the lever for a later PR.
//
// Pack: out[i, j] = image[offset_i + start_offset + j] for j below the
// record's remaining length (clamped to extent and to the image), else 0;
// a row whose offset is negative or past the image, or whose length is
// not positive, is all zero. One thread writes 16 output bytes: it reads
// them a byte at a time (record offsets have any alignment) and stores
// one 16-byte word where the destination is aligned and the chunk whole,
// bytes otherwise. It moves each output byte once and each record byte
// once; it is bound by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kMaxRdwRecordSize = 100LL * 1024 * 1024;  // native cap
constexpr int kThreads = 256;

enum ScanStatus : int64_t {
  kDone = 0,        // the chain reached the window's end
  kCarry = 1,       // stopped at a record that continues past the window
  kZero = -1,       // zero-length header at the stop position
  kTooBig = -2,     // oversized header at the stop position
};

__device__ __forceinline__ int64_t header_length(const uint8_t* img,
                                                 int64_t p, int big_endian,
                                                 int adjustment) {
  const int64_t len = big_endian
      ? (int64_t)img[p + 1] + 256 * (int64_t)img[p]
      : (int64_t)img[p + 2] + 256 * (int64_t)img[p + 3];
  return len + adjustment;
}

__device__ __forceinline__ bool valid_at(const uint8_t* img, int64_t p,
                                         int64_t L, int big_endian,
                                         int adjustment, int last_window,
                                         int64_t* len_out) {
  if (p + 4 > L) return false;
  const int64_t len = header_length(img, p, big_endian, adjustment);
  *len_out = len;
  return len > 0 && len <= kMaxRdwRecordSize &&
         (last_window || p + 4 + len <= L);
}

__global__ void rdw_links(const uint8_t* __restrict__ img, int64_t L,
                          int64_t start, int big_endian, int adjustment,
                          int last_window, int32_t* __restrict__ jump,
                          uint8_t* __restrict__ valid,
                          uint8_t* __restrict__ reached) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p <= L;
       p += stride) {
    int64_t len = 0;
    const bool ok =
        valid_at(img, p, L, big_endian, adjustment, last_window, &len);
    const int64_t nxt = ok ? p + 4 + len : L;
    jump[p] = static_cast<int32_t>(nxt < L ? nxt : L);
    valid[p] = ok;
    reached[p] = p == start;
  }
}

__global__ void rdw_double(const int32_t* __restrict__ jin,
                           int32_t* __restrict__ jout,
                           uint8_t* reached, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const int32_t j = jin[p];
    if (reached[p]) reached[j] = 1;
    jout[p] = jin[j];
  }
}

// starts = reached & valid over [0, L); last = 1 + the largest reached
// position below L (0: none)
__global__ void rdw_finish(const uint8_t* __restrict__ valid,
                           const uint8_t* __restrict__ reached,
                           uint8_t* __restrict__ starts, int64_t L,
                           unsigned int* last) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned int mine = 0;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < L;
       p += stride) {
    const uint8_t r = reached[p];
    starts[p] = r & valid[p];
    if (r) mine = static_cast<unsigned int>(p + 1);
  }
  mine = __reduce_max_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicMax(last, mine);
}

// per compacted start: payload offset and length clamped to the window;
// thread 0 also writes the window's status {code, position, length}
__global__ void rdw_records(const uint8_t* __restrict__ img, int64_t L,
                            int big_endian, int adjustment, int last_window,
                            const int64_t* __restrict__ pos, int64_t n,
                            int64_t* __restrict__ offsets,
                            int64_t* __restrict__ lengths,
                            const uint8_t* __restrict__ valid,
                            const unsigned int* __restrict__ last,
                            int64_t* __restrict__ status) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n; i += stride) {
    const int64_t p = pos[i];
    const int64_t len = header_length(img, p, big_endian, adjustment);
    const int64_t avail = L - (p + 4);
    offsets[i] = p + 4;
    lengths[i] = len < avail ? len : avail;
  }
  if (tid != 0) return;
  const unsigned int q1 = *last;
  int64_t code = kDone, at = L, len = 0;
  if (q1 != 0) {
    const int64_t q = static_cast<int64_t>(q1) - 1;
    if (!valid[q]) {
      at = q;
      if (q + 4 <= L) {
        len = header_length(img, q, big_endian, adjustment);
        code = len <= 0 ? kZero : len > kMaxRdwRecordSize ? kTooBig : kCarry;
      } else {
        code = last_window ? kDone : kCarry;  // header cut by the window
      }
    }
  }
  status[0] = code;
  status[1] = at;
  status[2] = len;
}

__global__ void pack_records_kernel(const uint8_t* __restrict__ img,
                                    int64_t size,
                                    const int64_t* __restrict__ offsets,
                                    const int64_t* __restrict__ lengths,
                                    int64_t n, int64_t extent,
                                    int64_t start_offset,
                                    uint8_t* __restrict__ out) {
  const int64_t chunks = (extent + 15) / 16;
  const int64_t total = n * chunks;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / chunks;
    const int64_t j0 = (t - i * chunks) * 16;
    const int64_t off = offsets[i] + start_offset;
    int64_t len = lengths[i] - start_offset;
    if (len > extent) len = extent;
    if (off < 0 || len <= 0 || off >= size) {
      len = 0;
    } else if (off + len > size) {
      len = size - off;
    }
    const int64_t width = extent - j0 < 16 ? extent - j0 : 16;
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int64_t j = j0 + k;
      const uint32_t b = (k < width && j < len) ? __ldg(img + off + j) : 0u;
      w[k >> 2] |= b << (8 * (k & 3));
    }
    uint8_t* dst = out + i * extent + j0;
    if (width == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int k = 0; k < width; ++k) dst[k] = (w[k >> 2] >> (8 * (k & 3))) & 0xff;
    }
  }
}

int blocks_for(int64_t work) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 132;
  }
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
}

}  // namespace

// The reachability part of the scan: links, `steps` doubling steps,
// starts and the last reached position. jump_a and jump_b hold L + 1
// int32 each; valid, reached and starts L + 1 bytes; last one uint32,
// zeroed by the caller. start <= L.
extern "C" int cobrix_rdw_scan(const void* img, int64_t L, int64_t start,
                               int32_t big_endian, int32_t adjustment,
                               int32_t last_window, int32_t steps,
                               void* jump_a, void* jump_b, void* valid,
                               void* reached, void* starts, void* last,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(L + 1);
  auto* ja = static_cast<int32_t*>(jump_a);
  auto* jb = static_cast<int32_t*>(jump_b);
  auto* r = static_cast<uint8_t*>(reached);
  rdw_links<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(img), L,
                                      start, big_endian, adjustment,
                                      last_window, ja, static_cast<uint8_t*>(valid),
                                      r);
  for (int k = 0; k < steps; ++k) {
    rdw_double<<<grid, kThreads, 0, s>>>(ja, jb, r, L + 1);
    int32_t* t = ja;
    ja = jb;
    jb = t;
  }
  rdw_finish<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(valid), r,
                                       static_cast<uint8_t*>(starts), L,
                                       static_cast<unsigned int*>(last));
  return static_cast<int>(cudaGetLastError());
}

// Offsets and lengths of the n compacted starts `pos`, and the status
// {code, position, length} (int64 x 3) of the window.
extern "C" int cobrix_rdw_records(const void* img, int64_t L,
                                  int32_t big_endian, int32_t adjustment,
                                  int32_t last_window, const void* pos,
                                  int64_t n, void* offsets, void* lengths,
                                  const void* valid, const void* last,
                                  void* status, void* stream) {
  rdw_records<<<blocks_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), L, big_endian, adjustment,
      last_window, static_cast<const int64_t*>(pos), n,
      static_cast<int64_t*>(offsets), static_cast<int64_t*>(lengths),
      static_cast<const uint8_t*>(valid),
      static_cast<const unsigned int*>(last), static_cast<int64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

// Zero-padded [n, extent] uint8 matrix of the records (offset, length)
// of an image of `size` bytes, from start_offset into each record.
extern "C" int cobrix_pack_records(const void* img, int64_t size,
                                   const void* offsets, const void* lengths,
                                   int64_t n, int64_t extent,
                                   int64_t start_offset, void* out,
                                   void* stream) {
  if (n <= 0 || extent <= 0) return 0;
  const int64_t work = n * ((extent + 15) / 16);
  pack_records_kernel<<<blocks_for(work), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), size,
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(lengths), n, extent, start_offset,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
