"""Host staging for the pipelined read: pinned buffers and worker streams.

This part of the pipeline has no counterpart in the JAX package, where
XLA moves a host array to the device on its own. It is PyTorch's form of
the same data flow:

* `StagingPool` is a bounded pool of host buffers that the reader thread
  reads chunks and shards into. On a CUDA read they are page-locked
  (``torch.empty(..., pin_memory=True)``), so a chunk crosses to the card
  with an asynchronous copy on the worker's stream; on a CPU read
  (``device="cpu"``, which the caller asks for) they are plain host
  memory and a chunk is cloned out of its buffer.
* A buffer goes back to the pool with a CUDA event recorded after the
  last copy out of it, and the pool hands it out again only after that
  event has completed: reusing it earlier would overwrite a chunk whose
  copy to the card is still in flight.
* `worker_stream(device)` makes the calling thread's own CUDA stream
  current, one stream per decode worker thread, so that one worker's
  copies and kernels overlap another's.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple

import torch

class StagedBytes:
    """`nbytes` bytes of a file in a host staging buffer: `host()` is
    the CPU uint8 tensor of them (its `.numpy()` a view), `to_device`
    copies a slice to the device on the current stream, and `close()`
    gives the buffer back (idempotent; also called by the pipeline for a
    payload it never processed)."""

    def __init__(self, pool: Optional["StagingPool"], buf: torch.Tensor,
                 nbytes: int):
        self._pool = pool
        self._buf = buf
        self.nbytes = nbytes
        self._stream: Optional[torch.cuda.Stream] = None

    def host(self) -> torch.Tensor:
        if self._buf is None:
            raise RuntimeError("staged bytes used after close()")
        return self._buf[:self.nbytes]

    def to_device(self, device: torch.device, lo: int = 0,
                  hi: Optional[int] = None) -> torch.Tensor:
        """Bytes [lo, hi) on `device`: an asynchronous copy from the
        pinned buffer on the current CUDA stream, or a clone on the
        CPU (the buffer is reused once closed)."""
        part = self.host()[lo:hi]
        if device.type == "cpu":
            return part.clone()
        out = part.to(device, non_blocking=True)
        self._stream = torch.cuda.current_stream(device)
        return out

    def close(self) -> None:
        buf, self._buf = self._buf, None
        if buf is None:
            return
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
        if self._pool is not None:
            self._pool.release(buf, event)


class StagingPool:
    """At most `capacity` host staging buffers, reused in turn: pinned
    when `device` is CUDA, plain otherwise. A buffer is reused for any
    request that fits it; a request larger than every free buffer
    replaces one of them."""

    def __init__(self, capacity: int, device: torch.device):
        self.capacity = max(1, capacity)
        self.pin = device.type == "cuda"
        self._cond = threading.Condition()
        self._free: List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = []
        self._count = 0
        self.allocations = 0   # buffers allocated (reuse = acquires - this)
        self.acquires = 0
        self.wait_s = 0.0      # seconds readers waited for a free buffer

    def _alloc(self, nbytes: int) -> torch.Tensor:
        """A buffer of the next power of two at or above `nbytes` (the
        pinned allocator's own block size), so that shards of varying
        sizes keep reusing it."""
        with self._cond:
            self.allocations += 1
        return torch.empty(1 << max(0, nbytes - 1).bit_length(),
                           dtype=torch.uint8, pin_memory=self.pin)

    def acquire(self, nbytes: int) -> StagedBytes:
        """A buffer of at least `nbytes` bytes, waiting while all
        `capacity` buffers are out (a stopped pipeline closes the
        payloads it drains, which frees them). Waits for the buffer's
        last copy to complete."""
        with self._cond:
            while True:
                fit = [k for k, (b, _) in enumerate(self._free)
                       if b.numel() >= nbytes]
                if fit:
                    buf, event = self._free.pop(min(
                        fit, key=lambda k: self._free[k][0].numel()))
                    break
                if self._count < self.capacity:
                    self._count += 1
                    buf, event = None, None
                    break
                if self._free:
                    # every free buffer is too small: replace the largest
                    self._free.sort(key=lambda be: be[0].numel())
                    _, event = self._free.pop()
                    buf = None
                    break
                self._cond.wait()
            self.acquires += 1
        if event is not None:
            event.synchronize()
        if buf is None:
            buf = self._alloc(nbytes)
        return StagedBytes(self, buf, nbytes)

    def fresh(self, nbytes: int) -> StagedBytes:
        """A buffer outside the pool (a re-read after a failed attempt
        must not wait for buffers that queued chunks hold)."""
        return StagedBytes(None, self._alloc(nbytes), nbytes)

    def add_wait(self, seconds: float) -> None:
        with self._cond:
            self.wait_s += seconds

    def report(self) -> dict:
        """Buffers, pinning, acquires, allocations and the wait."""
        with self._cond:
            return {"buffers": self.capacity, "pinned": self.pin,
                    "acquires": self.acquires,
                    "allocations": self.allocations,
                    "wait_s": round(self.wait_s, 6)}

    def release(self, buf: torch.Tensor,
                event: Optional[torch.cuda.Event]) -> None:
        with self._cond:
            self._free.append((buf, event))
            self._cond.notify()


_local = threading.local()


@contextlib.contextmanager
def worker_stream(device: torch.device):
    """Run the block on the calling thread's own CUDA stream on `device`
    (created at the thread's first use); a no-op on the CPU."""
    if device.type != "cuda":
        yield None
        return
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    stream = streams.get(device)
    if stream is None:
        stream = streams[device] = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        yield stream
