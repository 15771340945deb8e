"""Per-field / kernel-group cost attribution.

`ReadMetrics` attributes time to pipeline *stages* (read / frame /
decode / assemble) — enough to see that decode is hot, useless for
deciding WHICH copybook fields to optimize. The vectorized-decoding
literature starts every win from a per-format cost breakdown
("Decoding billions of integers per second through vectorization",
PAPERS.md); this module is that breakdown for the scan plane.

One `FieldCostAccumulator` rides each read's `ObsContext` exactly like
`IoStats`: every thread working for the read sees the same object, and
forked multihost workers ship their worker-local table home over the
existing result pipes for merging. Timers wrap each *kernel-group*
call (the merged NumericGroupsPlan pass, per-group COMP-3 / zoned
decimal / binary kernels, text transcode, decimal128 batch build) plus
the per-column Arrow-assembly step — call-granularity, never
per-record, so the cost is a few perf_counter pairs per chunk.

Attribution rules:

* a group call's elapsed time splits equally across the group's
  columns (same codec, same width — the kernels are column-symmetric);
  the merged numeric pass splits across its groups weighted by
  ``n_columns * width`` (bytes touched) first;
* columns that are OCCURS slots of one statement share the statement
  name, so their shares merge into one per-field row;
* regions nest (a column's assembly step triggers the group's string
  transcode): each region charges its SELF time — elapsed minus the
  time of attribution regions nested inside it — so planes never
  double-count (thread-local nesting stack, no locks on the fast path);
* two planes per field: ``decode_s`` (work inside the decode stage:
  eager numeric kernels, host fallback, masked-segment kernels) and
  ``assemble_s`` (Arrow materialization — the fused native one-pass
  decode->Arrow assembly, the lazily-deferred string transcode, and
  lazy numeric plane materialization all run at output time by design,
  so they charge here). sum(decode_s) over all fields therefore tracks
  the decode-stage busy time: exactly on the pure-Python path (where
  every kernel runs inside the stage), as an upper bound on the native
  path (where deferred groups leave only framing/pack work in the
  stage). The fused assembly's coarse per-pass timings are taken in
  Python AROUND the GIL-released native call, split across its columns
  by bytes touched — `explain=True` never loses the assemble_s plane
  to native code.

Overhead discipline: when attribution is off, every call site gates on
`current()` returning None — one thread-local read, no timers taken.
`timer_calls()` counts every timed region started process-wide, so a
test can assert the disabled path takes literally zero timestamps.

Port copy of ``cobrix_tpu.obs.fieldcost``. One change: `_charge`
updates a field once with the count of the columns that share its name
(an OCCURS field's 2,000 slots are one update, not 2,000), so a wide
batch's commit costs microseconds; the table it builds is the same.
Where the port
charges (its decoder has no lazy planes and no native passes): the
decode plane in ``ColumnarDecoder`` — one region a batch, opened
before the batch's first transfer or launch (its H2D, or its pack) and
committed after the batch's one synchronize and its ``collect_outputs``
(``_commit_decode``), split across the kernel groups by bytes as the
JAX package splits its jitted device decode — and per column in
``_decode_host_fallback``; the assemble
plane around each batch's card assembly (``reader.arrow_out``: one
region over ``ops.arrow_assemble.assemble``, which ends in its own
synchronize, split across the assembled columns by bytes) and around
the value-list route's columns. No region adds a synchronize, an event
or a timer where attribution is off.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# process-wide count of attribution regions STARTED (i.e. perf_counter
# pairs taken). Plain int += under the GIL: the counter is a test /
# debugging aid, an off-by-a-few race would not matter — but the value
# that does matter, "exactly zero when disabled", is exact because the
# disabled path never reaches _begin at all.
_TIMER_CALLS = 0


def timer_calls() -> int:
    """How many attribution regions have ever been started in this
    process — the counter behind the 'disabled means no timer calls on
    the hot path' regression test."""
    return _TIMER_CALLS


# internal per-field slot layout (mutable list: cheapest upsert)
_DECODE, _ASSEMBLE, _BYTES, _VALUES, _CALLS = range(5)

PLANE_DECODE = "decode"
PLANE_ASSEMBLE = "assemble"


class FieldCostAccumulator:
    """Thread-safe per-field cost table for one read."""

    __slots__ = ("_lock", "_tls", "_fields", "_kernels")

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        # field name -> [decode_s, assemble_s, bytes, values, calls]
        self._fields: Dict[str, List[float]] = {}
        # field name -> kernel family label (last writer wins; a field
        # decodes with exactly one kernel family per plan)
        self._kernels: Dict[str, str] = {}

    # -- timed regions (nesting-aware) ----------------------------------

    def begin(self) -> Tuple[float, List[float]]:
        """Open an attribution region on this thread. Returns the token
        `commit_*` consumes. Nested regions subtract their elapsed time
        from the enclosing region's charge, so a group build triggered
        inside a column's assembly step is charged once, to itself."""
        global _TIMER_CALLS
        _TIMER_CALLS += 1
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        frame = [0.0]  # seconds consumed by nested regions
        stack.append(frame)
        return (time.perf_counter(), frame)

    def _end(self, token) -> float:
        """Close the region; returns its SELF seconds (elapsed minus
        nested regions) and propagates the full elapsed to the parent."""
        t0, frame = token
        elapsed = time.perf_counter() - t0
        stack = self._tls.stack
        # the frame is normally on top; a mismatched interleave (caller
        # bug) degrades to removal, never to a crash on the hot path
        if stack and stack[-1] is frame:
            stack.pop()
        elif frame in stack:  # pragma: no cover - defensive
            stack.remove(frame)
        if stack:
            stack[-1][0] += elapsed
        return max(0.0, elapsed - frame[0])

    def commit(self, token, names: Sequence[str], plane: str,
               nbytes_per_field: int, values_per_field: int,
               kernel: str = "") -> None:
        """Close the region and split its self time equally across
        `names` (the columns of one kernel group). `nbytes_per_field` /
        `values_per_field` are per COLUMN; columns sharing a name
        (OCCURS slots) merge additively."""
        seconds = self._end(token)
        if not names:
            return
        share = seconds / len(names)
        self._charge(names, share, plane, nbytes_per_field,
                     values_per_field, kernel)

    def commit_weighted(self, token,
                        groups: Iterable[Tuple[Sequence[str], int, int,
                                               str]],
                        plane: str, values_per_field: int) -> None:
        """Close the region and split its self time across several
        kernel groups at once (the merged NumericGroupsPlan pass: one
        native call decodes every narrow numeric group). Each entry is
        ``(names, width, n_rows_bytes_per_field, kernel)``; group weight
        is ``len(names) * width`` — the bytes the pass touched for it."""
        seconds = self._end(token)
        groups = list(groups)
        total_w = sum(len(names) * width for names, width, _, _ in groups)
        if total_w <= 0:
            return
        for names, width, nbytes_per_field, kernel in groups:
            if not names:
                continue
            share = seconds * (len(names) * width) / total_w / len(names)
            self._charge(names, share, plane, nbytes_per_field,
                         values_per_field, kernel)

    def discard(self, token) -> None:
        """Close a region without charging anyone (the kernel call
        failed / returned None and a fallback path will re-time)."""
        self._end(token)

    def _charge(self, names: Sequence[str], seconds_each: float,
                plane: str, nbytes: int, values: int,
                kernel: str) -> None:
        idx = _DECODE if plane == PLANE_DECODE else _ASSEMBLE
        # columns sharing a name (OCCURS slots) charge once with their
        # count: the same sums, one dict update a field
        counts = Counter(names)
        with self._lock:
            for name, k in counts.items():
                slot = self._fields.get(name)
                if slot is None:
                    slot = [0.0, 0.0, 0, 0, 0]
                    self._fields[name] = slot
                slot[idx] += seconds_each * k
                slot[_BYTES] += nbytes * k
                slot[_VALUES] += values * k
                slot[_CALLS] += k
                if kernel:
                    self._kernels[name] = kernel

    # -- aggregation -----------------------------------------------------

    def merge(self, table: Dict[str, dict]) -> None:
        """Fold a worker's `as_dict()` into this accumulator (multihost
        shards attribute into a worker-local table and ship it over the
        result pipe; same contract as IoStats.merge)."""
        with self._lock:
            for name, row in table.items():
                slot = self._fields.get(name)
                if slot is None:
                    slot = [0.0, 0.0, 0, 0, 0]
                    self._fields[name] = slot
                slot[_DECODE] += float(row.get("decode_s", 0.0))
                slot[_ASSEMBLE] += float(row.get("assemble_s", 0.0))
                slot[_BYTES] += int(row.get("bytes", 0))
                slot[_VALUES] += int(row.get("values", 0))
                slot[_CALLS] += int(row.get("calls", 0))
                kernel = row.get("kernel")
                if kernel:
                    self._kernels[name] = kernel

    @property
    def is_zero(self) -> bool:
        with self._lock:
            return not self._fields

    def as_dict(self) -> Dict[str, dict]:
        """{field -> {kernel, decode_s, assemble_s, busy_s, bytes,
        values, calls}}, ordered by descending total busy seconds."""
        with self._lock:
            rows = [(name, list(slot)) for name, slot in
                    self._fields.items()]
            kernels = dict(self._kernels)
        rows.sort(key=lambda r: -(r[1][_DECODE] + r[1][_ASSEMBLE]))
        return {
            name: {
                "kernel": kernels.get(name, ""),
                "decode_s": round(slot[_DECODE], 6),
                "assemble_s": round(slot[_ASSEMBLE], 6),
                "busy_s": round(slot[_DECODE] + slot[_ASSEMBLE], 6),
                "bytes": int(slot[_BYTES]),
                "values": int(slot[_VALUES]),
                "calls": int(slot[_CALLS]),
            }
            for name, slot in rows
        }

    def decode_busy_s(self) -> float:
        with self._lock:
            return sum(slot[_DECODE] for slot in self._fields.values())


def current() -> Optional[FieldCostAccumulator]:
    """The active read's accumulator, or None when attribution is off —
    ONE thread-local read; the disabled hot path stops here."""
    from .context import current as obs_current

    ctx = obs_current()
    return ctx.field_costs if ctx is not None else None


def top_fields(table: Dict[str, dict], n: int = 5) -> List[dict]:
    """The N most expensive rows of an `as_dict()` table as a list of
    {field, **costs} records (the shape bench.py embeds)."""
    out = []
    for name, row in table.items():  # as_dict() is busy-sorted already
        out.append({"field": name, **row})
        if len(out) >= n:
            break
    return out
