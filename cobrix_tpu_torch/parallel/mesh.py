"""The device "mesh" of the port: one card for now.

Port of ``cobrix_tpu.parallel.mesh``. The JAX package shards record
batches over a 1-D ``data`` mesh of devices; the port runs on one CUDA
device (or the CPU), so a mesh is ``None`` or a sequence that holds
exactly one ``torch.device``, and anything larger raises
NotImplementedError until more than one device is ported (ROADMAP A7).
``batch_sharding`` and ``replicated_sharding`` have no counterpart until
then. `pad_batch_to_multiple` is copied unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def mesh_device(mesh: Optional[Sequence] = None, device=None) -> torch.device:
    """The one device of `mesh` (None: `device`, resolved as every entry
    point resolves it). A mesh of more than one device raises
    NotImplementedError naming ROADMAP A7; a one-device mesh that
    disagrees with `device` raises ValueError."""
    if mesh is None:
        return resolve_device(device)
    devices = list(mesh)
    if len(devices) != 1:
        raise NotImplementedError(
            f"cobrix_tpu_torch runs on one device; a mesh of "
            f"{len(devices)} devices waits for ROADMAP A7 (more than one "
            f"device)")
    (dev,) = devices
    if not isinstance(dev, torch.device):
        raise TypeError(f"a mesh holds torch.device objects, not "
                        f"{type(dev).__name__}")
    dev = resolve_device(dev)
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"mesh device {dev} and device {device} differ")
    return dev


def pad_batch_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading axis up to a multiple (zero records decode to valid
    garbage that the caller slices off or masks)."""
    n = arr.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    padded = np.zeros((target,) + arr.shape[1:], dtype=arr.dtype)
    padded[:n] = arr
    return padded
