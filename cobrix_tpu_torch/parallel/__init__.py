"""The device-resident query path on one device: the decode and the
per-field reductions stay on the card, and only scalars come back.

Port of the single-device part of ``cobrix_tpu.parallel``. The shard
planner, the multi-host supervisor and meshes of more than one device
wait for ROADMAP A7.
"""
from .mesh import pad_batch_to_multiple
from .query import DeviceAggregator, aggregate_file, merge_aggregates
from .sharded import ShardedColumnarDecoder, sharded_decode

__all__ = [
    "DeviceAggregator", "aggregate_file", "merge_aggregates",
    "ShardedColumnarDecoder", "sharded_decode", "pad_batch_to_multiple",
]
