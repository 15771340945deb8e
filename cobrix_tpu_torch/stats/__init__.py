"""Scan-time data profiler: persisted per-chunk statistics and their
consumers.

The pieces, in dependency order:

* ``profile``   — the data model: per-chunk per-field min/max zone
  maps, null counts, segment-id histograms, record-length histograms,
  bounded distinct-value sketches; JSON round-trip.
* ``collect``   — the profiler: a deterministic standalone decode pass
  over a canonical chunk grid (``collect_stats=true``), on the read's
  device, identical across sequential and pipelined execution *by
  construction* because it never rides the scan's own execution plan.
* ``store``     — persistence: CRC-stamped JSON entries under
  ``<cache_dir>/stats/`` keyed by file fingerprint + config
  fingerprint (the sparse-index store's contract, plane="stats").
* ``skip``      — the consuming side: zone-map/segment-histogram chunk
  skipping BEFORE framing (``use_stats=true``); conservative tri-state
  evaluation, never a wrong skip.
* ``aggregate`` — count/min/max/sum answered from statistics alone
  when provably exact (``query.dataset().aggregate()``).
* ``drift``     — successive-generation profile comparison for a
  continuous-ingest tailer (segment-mix shifts, null-rate spikes,
  out-of-range values).
* ``service``   — the process-wide registry a ``/stats`` endpoint
  serves.

Everything is opt-in: with both options off, no module here is even
imported by a read (the zero-overhead contract
``collect.overhead_events`` asserts in the tests).

Port copy of ``cobrix_tpu.stats``. Not carried over yet (ROADMAP A8):
the HTTP ``/stats`` endpoint and ``/fleet/stats`` federation (the serve
tier), the tailer's drift records (streaming), and multihost profiling
and skipping (A7).
"""
from .profile import ChunkStats, FieldStats, FileProfile  # noqa: F401
from .skip import ChunkSkipper, maybe_attach_skipper  # noqa: F401
from .store import StatsStore, stats_config_fingerprint  # noqa: F401
