"""The device-resident decoder: `put` a batch on the card, decode it
there, and reduce it there.

Port of ``cobrix_tpu.parallel.sharded`` on one device (`parallel.mesh`):
`ShardedColumnarDecoder` is a `ColumnarDecoder` whose batches stay on
the device. It has no ``backend`` argument: the device decides it, so
``resolve_device_backend`` has no counterpart. The JAX package pads a
batch to its jit bucket; the port needs no bucket and pads only to the
mesh's device count, but padded rows, which decode as valid zeros, are
masked by the live row count `n` all the same.

`decode_stats` counts, per kernel group, the valid values of the rows
below `n` with torch sums over the groups' bool valid planes (the fused
kernel's bool plane for the numeric groups, ``batch_torch``'s valid
outputs for the floats), and brings every count back in one copy: the
JAX package's keys ``f"{codec}_w{width}"`` (a later group of the same
codec and width overwrites an earlier one's entry, as there),
``valid_values`` and ``records``.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..copybook.copybook import Copybook
from ..plan.compiler import Codec
from ..reader.columnar import ColumnarDecoder, DecodedBatch
from .mesh import mesh_device, pad_batch_to_multiple


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One copy of a host array to `device`: through a pinned buffer and
    a non-blocking copy on the current stream (PyTorch keeps the pinned
    block until the copy is done); a CPU device gets a copy."""
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        # a read-only array (bytes, mmap) is only read here
        warnings.filterwarnings("ignore", message=".*not writable.*")
        host = torch.from_numpy(arr)
    if device.type == "cpu":
        return host.clone()
    return host.pin_memory().to(device, non_blocking=True)


class ShardedColumnarDecoder(ColumnarDecoder):
    """A ColumnarDecoder over a mesh of one device (`parallel.mesh`),
    with the device-resident `put` and `decode_stats`."""

    def __init__(self, copybook: Copybook, mesh=None,
                 active_segment: Optional[str] = None, select=None,
                 device=None):
        dev = mesh_device(mesh, device)
        super().__init__(copybook, active_segment=active_segment,
                         select=select, device=dev)
        self.mesh = (dev,)

    def rebuild_groups(self) -> None:
        super().rebuild_groups()
        self._stats_tables = None  # built again for the new groups

    @property
    def n_devices(self) -> int:
        return len(self.mesh)

    def _mesh_bucket(self, n: int) -> int:
        """Batch padding target: a multiple of the device count (at least
        one row a device)."""
        nd = self.n_devices
        return -(-max(n, nd) // nd) * nd

    def put(self, arr: np.ndarray):
        """Pad `arr` ([n, extent] uint8) to the mesh bucket and copy it to
        the device once. Returns (device tensor, n)."""
        n = arr.shape[0]
        padded = pad_batch_to_multiple(arr, self._mesh_bucket(n))
        return host_to_device(padded, self.device), n

    def _stats_layout(self):
        """(row -> stat slot index on the device, slot keys, the non-fused
        groups with a valid output): the fused groups' valid rows of the
        bool plane, each mapped to its group's slot; the bool plane's
        other rows (wide negatives) to a slot past the end."""
        if self._stats_tables is None:
            keys, fused_rows = [], []
            if self.fused is not None:
                slot_of_row = np.full(self.fused.rows["bool"], -1, np.int64)
                for gi, g, slots in zip(self.fused_indices, self.fused.groups,
                                        self.fused.slots):
                    valid = [s for p, s in slots if p == "bool"][-1]
                    slot_of_row[valid:valid + g.count] = len(keys)
                    kg = self.kernel_groups[gi]
                    keys.append(f"{kg.codec.value}_w{kg.width}")
                fused_rows = slot_of_row
            others = []
            for gi, g in enumerate(self.kernel_groups):
                if gi in self.fused_indices or g.codec not in (
                        Codec.FLOAT_IBM, Codec.FLOAT_IEEE, Codec.DOUBLE_IBM,
                        Codec.DOUBLE_IEEE):
                    continue
                others.append((gi, len(keys)))
                keys.append(f"{g.codec.value}_w{g.width}")
            rows = np.asarray(fused_rows, dtype=np.int64)
            rows[rows < 0] = len(keys)
            self._stats_tables = (torch.from_numpy(rows).to(self.device),
                                  keys, others)
        return self._stats_tables

    def decode_stats(self, arr, n=None) -> Dict[str, int]:
        """The record count and each group's count of valid values over
        the rows below `n`. Pass a host [n, extent] array, or a device
        batch from `put` with its `n` (a host int or a 0-d tensor on the
        device)."""
        if n is None:
            arr, n = self.put(np.asarray(arr, dtype=np.uint8))
        extent = self.plan.max_extent
        if arr.shape[1] < extent:
            arr = torch.nn.functional.pad(arr, (0, extent - arr.shape[1]))
        rows, keys, others = self._stats_layout()
        dp = self.decode_planes(arr.contiguous())
        N = arr.shape[0]
        live = torch.arange(N, device=self.device) < n
        counts = torch.zeros(len(keys) + 1, dtype=torch.int32,
                             device=self.device)
        if dp.planes is not None:
            per_row = (dp.planes["bool"] & live[None, :]).sum(
                1, dtype=torch.int32)
            counts.index_add_(0, rows, per_row)
        for gi, slot in others:
            valid = dp.groups[gi][1]
            counts[slot] += (valid & live[:, None]).sum(dtype=torch.int32)
        records = (n.reshape(1).to(device=self.device, dtype=torch.int32)
                   if isinstance(n, torch.Tensor) else None)
        host = (torch.cat([counts, records]) if records is not None
                else counts).cpu().tolist()
        per_group: Dict[str, int] = {}
        for key, v in zip(keys, host):
            per_group[key] = v
        return {"records": host[-1] if records is not None else int(n),
                "valid_values": sum(host[:len(keys)]), **per_group}


def sharded_decode(copybook: Copybook, data, mesh=None,
                   lengths: Optional[np.ndarray] = None,
                   device=None) -> DecodedBatch:
    """One-shot helper: decode bytes or an [N, rs] uint8 array on the
    mesh's device."""
    dec = ShardedColumnarDecoder(copybook, mesh=mesh, device=device)
    return dec.decode(data, lengths=lengths)
