"""Per-read observability context with explicit thread propagation.

One `ObsContext` bundles everything a read's execution threads need to
report into — the tracer (None when tracing is off), the metrics
registry's standard metric set, the progress tracker, and the per-read
compile-cache counter scope. `read_cobol` creates it and activates it on
the calling thread; the pipeline executor re-activates the SAME context
on every stage thread it spawns, and the var-len shard pool wraps its
scan closure — so attribution crosses thread pools deliberately instead
of leaking through process-globals (the plan_cache cross-read
contamination this replaces). Fork workers build their own context
(hosts.py) and ship spans home over the result pipes.

`current()` is a single thread-local read; every hot-path call site
gates on it being None, so the tracing-off cost is one attribute lookup.

Port copy of ``cobrix_tpu.obs.context``. The context also carries the
read's ``io.stats.IoStats`` (``io.stats.current_io_stats`` reads it, as
in the JAX package). Added: `carry(fn)`, which wraps a thread target or
a pool task to run with the context active where `carry` was called —
the one helper every thread the port starts for a read goes through
(the pipeline's stage threads, the index-shard pool, ``to_arrow``'s
``parallelism`` threads). `count_pass` is left out: the port has no
native passes to count.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

_tls = threading.local()


class ObsContext:
    """The read's observability bundle (any member may be None)."""

    __slots__ = ("tracer", "metrics", "progress", "cache_scope",
                 "io_stats", "field_costs")

    def __init__(self, tracer=None, metrics: Optional[dict] = None,
                 progress=None, cache_scope=None, io_stats=None,
                 field_costs=None):
        self.tracer = tracer
        self.metrics = metrics      # obs.metrics.scan_metrics() dict
        self.progress = progress    # obs.progress.ProgressTracker
        self.cache_scope = cache_scope  # plan.cache.CacheStatsScope
        self.io_stats = io_stats    # io.stats.IoStats (remote IO planes)
        # obs.fieldcost.FieldCostAccumulator — per-field/kernel-group
        # cost attribution; None = attribution off (the zero-cost
        # default: every timer site gates on this being None)
        self.field_costs = field_costs


def current() -> Optional[ObsContext]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def activate(ctx: Optional[ObsContext]):
    """Install `ctx` as the thread's observability context (and its
    cache scope as the thread's cache-counter sink). Pass None for a
    no-op — call sites never need their own guard."""
    if ctx is None:
        yield
        return
    from ..plan.cache import activate_scope, deactivate_scope

    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    prev_scope = (activate_scope(ctx.cache_scope)
                  if ctx.cache_scope is not None else None)
    try:
        yield
    finally:
        _tls.ctx = prev
        if ctx.cache_scope is not None:
            deactivate_scope(prev_scope)


def carry(fn: Callable) -> Callable:
    """`fn`, run with the observability context active where `carry` was
    called: a thread target or pool task started for the current read
    reports into the read's tracer, progress, cache scope, field costs
    and IoStats. Outside a read `fn` is returned as it is."""
    ctx = current()
    if ctx is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with activate(ctx):
            return fn(*args, **kwargs)
    return run
