"""Remote-storage and compressed-feed IO: fsspec byte-range backend,
read-ahead, caching, the decompression plane.

Port copy of ``cobrix_tpu.io``. The scheme registry in `reader.stream`
defines *how* a storage backend plugs in (a `ByteRangeSource` per URL);
this package supplies the implementations the engine runs against
object storage and compressed feeds:

* `compress`      — codec detection and `DecompressingSource`, a source
  over a compressed input's decompressed bytes with a seekable inflate
  index (`compress_index`) and a decompressed block plane.
* `fsspec_source` — a ByteRangeSource over any fsspec filesystem
  (`s3://`, `gs://`, `memory://`, ...), plus listing/size resolution so
  remote *directory* scans route through the backend. Unregistered
  schemes fall back to fsspec automatically when the protocol exists.
* `prefetch`      — `ReadAheadSource`: a bounded pool fetching the next
  N blocks ahead of the consumer (with range coalescing), so network
  latency overlaps framing/decode instead of serializing with it.
* `blockcache`    — `BlockCache` + `CachingSource`: a persistent
  on-disk LRU block cache keyed by (url, file fingerprint, range);
  repeated scans of hot remote files skip the network entirely.
* `index_store`   — `SparseIndexStore`: the variable-length sparse
  index persisted per file *version*, so the indexing pass on the card
  runs once and warm re-scans go straight to shard planning.
* `integrity`     — checksums, block framing, quarantine and the crash
  sweep every persisted plane verifies through.
* `config`        — `IoConfig` (the read's knobs) and `wrap_source`
  (the composition point `open_stream` calls).
* `stats`         — `IoStats`, the per-read counter bag surfaced on
  `ReadMetrics.as_dict()["io"]`.

Everything the JAX package exports but `PeerCacheTier` and
`registry_peers_fn`: the peer cache tier rides the serve wire protocol,
which is not ported (ROADMAP A8).
"""
from .config import IoConfig, wrap_source
from .blockcache import BlockCache, CachingSource
from .integrity import (checksum, corruption_counter, sweep_cache_root,
                        verify_json_payload)
from .fsspec_source import (FsspecSource, fsspec_listing, open_fsspec_source,
                            register_fsspec_backend)
from .index_store import SparseIndexStore, index_config_fingerprint
from .prefetch import ReadAheadSource
from .stats import IoStats

__all__ = [
    "IoConfig",
    "wrap_source",
    "BlockCache",
    "CachingSource",
    "checksum",
    "corruption_counter",
    "sweep_cache_root",
    "verify_json_payload",
    "FsspecSource",
    "fsspec_listing",
    "open_fsspec_source",
    "register_fsspec_backend",
    "SparseIndexStore",
    "index_config_fingerprint",
    "ReadAheadSource",
    "IoStats",
]
