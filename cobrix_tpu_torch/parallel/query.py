"""The device-resident query path: decode and aggregate on the card, and
bring back only the per-field scalars.

Port of ``cobrix_tpu.parallel.query`` on one device. `DeviceAggregator`
decodes a batch on the device (`ColumnarDecoder.decode_planes`: the fused
kernel and ``batch_torch``), reduces every selected numeric field there
(``ops.aggregate``: the hand-written kernel for the fused columns, torch
ops for the float groups) into one buffer of per-field statistics, and
copies that buffer back once (`fetch`). The query projects the decode to
its columns (`select`) and, where the columns it reads are sparse in the
record, `put` ships only their byte ranges (`_build_byte_projection`,
the JAX package's merged ranges, 0.9 density cut-off and
`gather_index`).

`submit` launches the work on the current stream and never waits for the
device: `n`, the live row count that masks the padding rows, may be a
0-d int32 tensor on the device (the count ``build_wide_pipeline`` leaves
there), read by the kernel where it lies. Counts are exact; a field with
no valid value reports None for sum, min and max.

Changes from the JAX package: the count is int32 as there, but the sums
run in another order (the kernel's blocks' partials, combined in a fixed
order), so they agree with the JAX program's to rounding, not bit for
bit; the aggregator takes `device` in place of ``backend``.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..copybook.copybook import Copybook
from ..ops.aggregate import (KIND_I32, KIND_I64, KIND_WIDE, MODE_CONST,
                             MODE_DIGITS, MODE_DOTS, MODE_NONE,
                             AggregateColumn, AggregateSpec, FloatSlot,
                             Stats, aggregate, aggregate_floats, read_stats)
from ..plan.compiler import Codec
from ..profiling import annotate
from ..reader.columnar import (_FLOAT_CODECS, _NUMERIC_CODECS, _dyn_scale,
                               fixed_point_exponent)
from .mesh import pad_batch_to_multiple
from .sharded import ShardedColumnarDecoder, host_to_device

_DISPLAY = (Codec.DISPLAY_NUM, Codec.DISPLAY_NUM_ASCII)
_DOUBLES = (Codec.DOUBLE_IBM, Codec.DOUBLE_IEEE)


class DeviceAggregator:
    """Decode + reduce on the device; only scalars come back.

    `columns`: field names to aggregate (numeric fields only; OCCURS
    elements of a field aggregate together). None = every numeric field
    in the plan. The decode is projected to those fields."""

    def __init__(self, copybook: Copybook,
                 columns: Optional[Sequence[str]] = None,
                 active_segment: Optional[str] = None,
                 mesh=None, pack_bytes: bool = True, device=None):
        self.decoder = ShardedColumnarDecoder(
            copybook, mesh=mesh, active_segment=active_segment,
            select=columns, device=device)
        self.device = self.decoder.device
        # byte width a [n, extent] record matrix must have BEFORE byte
        # projection (plan.max_extent shrinks when projection remaps)
        self.record_extent = self.decoder.plan.max_extent
        self.gather_index: Optional[np.ndarray] = None
        if pack_bytes:
            self._build_byte_projection()
        # field name -> [(group index, positions within the group)]
        per_field: Dict[str, Dict[int, List[int]]] = {}
        for gi, g in enumerate(self.decoder.kernel_groups):
            if g.codec not in _NUMERIC_CODECS and g.codec not in _FLOAT_CODECS:
                continue
            for pos, c in enumerate(g.columns):
                per_field.setdefault(c.name, {}).setdefault(gi, []).append(pos)
        self.fields = {name: [(gi, tuple(ps)) for gi, ps in by_group.items()]
                       for name, by_group in per_field.items()}
        self.spec = self._build()
        # every table the path reads goes to the device now, so that
        # `submit` copies nothing from the host
        self.spec.tables_on(self.device)
        if self.decoder.fused is not None:
            self.decoder.fused.tables_on(self.device)

    def _build_byte_projection(self):
        """Rewrite the plan's column offsets into a compacted layout
        covering only the byte ranges the query reads, so that `put`
        ships just those bytes. The plan is the decoder's own clone
        (``cached_compile_plan``), so later decoders of the copybook are
        untouched."""
        cols = self.decoder.plan.columns
        if not cols:
            return
        full_extent = self.record_extent
        ranges = sorted({(c.offset, c.width) for c in cols})
        merged: List[List[int]] = []
        for o, w in ranges:
            if merged and o <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], o + w)
            else:
                merged.append([o, o + w])
        total = sum(e - s for s, e in merged)
        if total >= full_extent * 0.9:
            return  # dense plan: the gather would cost more than it saves
        starts = [s for s, _ in merged]
        packed_start = {}
        pos = 0
        for s, e in merged:
            packed_start[s] = pos
            pos += e - s
        for c in cols:
            j = bisect.bisect_right(starts, c.offset) - 1
            s, _e = merged[j]
            c.offset = packed_start[s] + (c.offset - s)
        self.decoder.rebuild_groups()
        self.gather_index = np.concatenate(
            [np.arange(s, e, dtype=np.int64) for s, e in merged])

    @property
    def mesh(self):
        return self.decoder.mesh

    def _build(self) -> AggregateSpec:
        """The query's aggregate table: a row per fused column a field
        owns, with the JAX program's scale rule for it, and the float
        slots."""
        dec = self.decoder
        groups = dec.kernel_groups
        fused_at = {gi: k for k, gi in enumerate(dec.fused_indices)}
        columns: List[AggregateColumn] = []
        floats: List[FloatSlot] = []
        for fid, slots in enumerate(self.fields.values()):
            for gi, poss in slots:
                g = groups[gi]
                spec = g.columns[poss[0]]
                if g.codec in _FLOAT_CODECS:
                    floats.append(FloatSlot(gi, poss, g.codec in _DOUBLES,
                                            fid))
                    continue
                k = fused_at[gi]
                starts = [s for _, s in dec.fused.slots[k]]
                is_display = g.codec in _DISPLAY
                if g.wide:
                    value, lo, neg, valid = starts[:4]
                    kind = KIND_WIDE
                else:
                    (value, valid), lo, neg = starts[:2], -1, -1
                    kind = (KIND_I32 if dec.fused.groups[k].out == "i32"
                            else KIND_I64)
                dots = starts[-1] if is_display else -1
                sf, factor, mode = 0, 1.0, MODE_NONE
                if is_display and (spec.params.explicit_decimal
                                   or _dyn_scale(spec)):
                    mode = MODE_DOTS
                elif _dyn_scale(spec):
                    mode, sf = MODE_DIGITS, spec.params.scale_factor
                else:
                    e = fixed_point_exponent(spec)
                    if e:
                        mode, factor = MODE_CONST, 10.0 ** e
                for pos in poss:
                    columns.append(AggregateColumn(
                        value + pos, lo + pos if lo >= 0 else -1,
                        neg + pos if neg >= 0 else -1, valid + pos,
                        dots + pos if dots >= 0 else -1, kind, mode, sf,
                        fid, factor))
        return AggregateSpec(columns, floats, len(self.fields))

    def put(self, arr: np.ndarray, block: Optional[int] = None):
        """Byte-project `arr` ([n, record_extent] uint8) to the query's
        packed layout, pad it (to `block` rows, so that a streaming loop
        reuses one shape) and copy it to the device once, through a
        pinned buffer. Returns (device tensor, n)."""
        if (self.gather_index is not None
                and arr.shape[1] > len(self.gather_index)):
            # ship only the bytes the projected plan reads
            arr = np.ascontiguousarray(arr[:, self.gather_index])
        n = arr.shape[0]
        nd = self.decoder.n_devices
        if block is not None:
            multiple = -(-block // nd) * nd
        else:
            multiple = self.decoder._mesh_bucket(n)
        padded = pad_batch_to_multiple(arr, multiple)
        return host_to_device(padded, self.device), n

    def submit(self, x: torch.Tensor, n) -> Stats:
        """Decode and aggregate a device batch (from `put`, or the packed
        matrix of ``build_wide_pipeline``) on the current stream, WITHOUT
        waiting for the device; returns the device-side statistics for
        `fetch`. `n` (the live rows) is a host int or a 0-d int32 tensor
        on the device."""
        if isinstance(n, np.integer):
            n = int(n)
        extent = self.decoder.plan.max_extent
        if x.shape[1] < extent:
            x = torch.nn.functional.pad(x, (0, extent - x.shape[1]))
        with annotate("cobrix.aggregate", self.device):
            dp = self.decoder.decode_planes(x.contiguous())
            stats = self.spec.new_stats(self.device)
            if dp.planes is not None:
                aggregate(dp.planes, self.spec, n, stats)
            aggregate_floats(dp.groups, self.spec, n, stats)
        return stats

    def fetch(self, stats: Stats) -> Dict[str, dict]:
        """Copy the statistics of `submit` to the host in ONE copy (the
        synchronization point) and shape the result."""
        buf = stats.buffer
        if buf.device.type == "cpu":
            host = buf.numpy()
        else:
            pinned = torch.empty(buf.numel(), dtype=torch.uint8,
                                 pin_memory=True)
            pinned.copy_(buf, non_blocking=True)
            torch.cuda.current_stream(buf.device).synchronize()
            host = pinned.numpy()
        sums, counts, mins, maxs = read_stats(host, self.spec.n_fields)
        result: Dict[str, dict] = {}
        for i, name in enumerate(self.fields):
            count = int(counts[i])
            result[name] = {
                "sum": float(sums[i]) if count else None,
                "count": count,
                "min": float(mins[i]) if count else None,
                "max": float(maxs[i]) if count else None,
            }
        return result

    def aggregate_device(self, x: torch.Tensor, n) -> Dict[str, dict]:
        """Aggregate a batch already on the device (from `put`)."""
        return self.fetch(self.submit(x, n))

    def aggregate(self, arr: np.ndarray) -> Dict[str, dict]:
        """arr: [batch, extent] uint8. Per-field scalar aggregates; only
        these scalars come back from the device."""
        x, n = self.put(arr)
        return self.aggregate_device(x, n)


def merge_aggregates(parts: Sequence[Dict[str, dict]]) -> Dict[str, dict]:
    """Combine per-block partial aggregates from a streaming loop on the
    host (scalars only)."""
    result: Dict[str, dict] = {}
    for part in parts:
        for name, s in part.items():
            if name not in result:
                result[name] = dict(s)
                continue
            r = result[name]
            r["count"] += s["count"]
            if s["sum"] is not None:
                r["sum"] = s["sum"] + (r["sum"] or 0.0)
            if s["min"] is not None:
                r["min"] = s["min"] if r["min"] is None \
                    else min(r["min"], s["min"])
            if s["max"] is not None:
                r["max"] = s["max"] if r["max"] is None \
                    else max(r["max"], s["max"])
    return result


def aggregate_file(copybook: Copybook, data, columns=None, mesh=None,
                   device=None) -> Dict[str, dict]:
    """One-shot helper over a fixed-length byte image."""
    agg = DeviceAggregator(copybook, columns=columns, mesh=mesh,
                           device=device)
    rs = agg.record_extent
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size // copybook.record_size
    arr = arr[:n * copybook.record_size].reshape(n, copybook.record_size)
    return agg.aggregate(np.ascontiguousarray(arr[:, :rs]))
