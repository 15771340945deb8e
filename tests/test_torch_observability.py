"""The port's scan telemetry (``cobrix_tpu_torch.obs``) held to the JAX
package's: span parentage across the pipeline's threads, the
Chrome-trace schema, the Prometheus exposition, progress monotonicity,
the tracing-off fast path, the per-read cache scope — the single-process
cases of ``tests/test_observability.py`` on the port — and, on the same
bytes through both packages (JAX ``backend="numpy"``, port
``device="cpu"``): the tables, the trace's tree of span names and
categories, progress totals, the metric names and types after a read,
and the compile-cache counts of a cold and a warm read.

Where the port's execution differs from the JAX package's, the
comparison says so: the port's sequential RDW read frames each file
whole in one pass (its sparse index comes from that pass), so it has a
shard span and a unit of progress per file where the JAX package has one
per index shard, and no "plan_index" phase; its window reads sit inside
its "frame" stage. Left out here (ROADMAP A7): the forked multihost
cases (`test_multihost_trace_merges_worker_spans`,
`test_multihost_worker_metrics_ship_home`,
`test_progress_callback_multihost`).
"""
import collections
import json
import os
import re
import sys
import threading
import time

import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.testing.generators import (EXP1_COPYBOOK, EXP2_COPYBOOK,
                                           generate_exp1, generate_exp2)
from cobrix_tpu_torch import obs as tobs
from cobrix_tpu_torch.obs import (MetricsRegistry, ObsContext,
                                  ProgressTracker, Tracer, activate,
                                  current, maybe_span)
from cobrix_tpu_torch.profiling import ReadMetrics, StageTimes
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any table is built on a thread (ROADMAP C4)
warm_pyarrow()

EXP2_KW = dict(copybook_contents=EXP2_COPYBOOK, is_record_sequence="true",
               segment_field="SEGMENT-ID",
               redefine_segment_id_map="STATIC-DETAILS => C",
               redefine_segment_id_map_1="CONTACTS => P",
               segment_id_prefix="OBS")
EXP1_KW = dict(copybook_contents=EXP1_COPYBOOK)
PIPE = dict(pipeline_workers="2", chunk_size_mb="0.05")


def port_read(path, **kw):
    return cobrix_tpu_torch.read_cobol(path, device="cpu", **kw)


def jax_read(path, **kw):
    return cobrix_tpu.read_cobol(path, backend="numpy",
                                 **dict(kw, parallelism="1"))


@pytest.fixture(scope="module")
def exp1_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("obs") / "exp1.dat"
    p.write_bytes(generate_exp1(400, seed=21).tobytes())
    return str(p)


@pytest.fixture(scope="module")
def exp2_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("obs") / "exp2.dat"
    p.write_bytes(generate_exp2(3000, seed=22))
    return str(p)


def _spans_by_id(events):
    spans = [e for e in events if e.get("ph") == "X"]
    return spans, {e["args"]["span_id"]: e for e in spans}


def _edges(trace_path):
    """{(name, cat, ph, parent name/cat)}: the trace's tree of span
    names and categories."""
    events = json.load(open(trace_path))["traceEvents"]
    spans = [e for e in events if e["ph"] in ("X", "i")]
    by_id = {e["args"]["span_id"]: e for e in spans}
    out = set()
    for e in spans:
        p = by_id.get(e["args"]["parent_id"])
        out.add((e["name"], e["cat"], e["ph"],
                 f"{p['name']}/{p['cat']}" if p else None))
    return out


# -- trace spans: threads --------------------------------------------------

def test_pipelined_trace_span_parentage(tmp_path, exp1_path):
    """Chunk spans parent to the scan root; stage spans recorded on the
    pipeline's worker/assembler THREADS parent to their chunk span."""
    tf = str(tmp_path / "scan.trace.json")
    out = port_read(exp1_path, trace_file=tf, **EXP1_KW, **PIPE)
    assert len(out) == 400
    events = json.load(open(tf))["traceEvents"]
    spans, _ = _spans_by_id(events)
    roots = [e for e in spans if e["cat"] == "scan"]
    assert len(roots) == 1
    root_id = roots[0]["args"]["span_id"]
    chunks = [e for e in spans if e["cat"] == "chunk"]
    assert len(chunks) >= 2
    assert all(c["args"]["parent_id"] == root_id for c in chunks)
    chunk_ids = {c["args"]["span_id"] for c in chunks}
    stages = [e for e in spans if e["cat"] == "stage"]
    assert stages and all(s["args"]["parent_id"] in chunk_ids
                          for s in stages)
    assert len({(e["pid"], e["tid"]) for e in stages}) >= 2
    assert out.metrics.spans is not None
    assert out.metrics.as_dict()["span_count"] == len(out.metrics.spans)


def test_sequential_var_len_trace_has_shard_spans(tmp_path):
    """A sequential RDW read of three files: a shard span a file (the
    port frames each file whole), each under the scan root, with the
    reader's frame and decode stages under it."""
    d = tmp_path / "files"
    d.mkdir()
    for i in range(3):
        (d / f"part{i}.dat").write_bytes(generate_exp2(600, seed=40 + i))
    tf = str(tmp_path / "scan.trace.json")
    out = port_read(str(d), trace_file=tf, **EXP2_KW)
    assert len(out) == 1800
    spans, _ = _spans_by_id(json.load(open(tf))["traceEvents"])
    root_id = [e for e in spans if e["cat"] == "scan"][0]["args"]["span_id"]
    shards = [e for e in spans if e["cat"] == "shard"]
    assert len(shards) == 3
    assert all(s["args"]["parent_id"] == root_id for s in shards)
    shard_ids = {s["args"]["span_id"] for s in shards}
    stages = [e for e in spans if e["cat"] == "stage"]
    assert {s["name"] for s in stages} == {"frame", "decode"}
    assert all(s["args"]["parent_id"] in shard_ids for s in stages)


def test_clock_offset_correction_unit():
    host = Tracer()
    t = time.perf_counter()
    spans = [(123, host.root_id, "shard", "shard", "X", t, t + 1.0,
              9999, 1, None)]
    skew = 100.0
    worker_clock = (time.time(), time.perf_counter() - skew)
    host.merge(spans, worker_clock)
    merged = [s for s in host.spans if s[0] == 123][0]
    assert abs(merged[5] - (t + skew)) < 0.05


def test_span_ids_unique_across_tracers_in_one_process():
    a, b = Tracer(), Tracer()
    ids = {a.root_id, b.root_id}
    for _ in range(50):
        ids.add(a.new_id())
        ids.add(b.new_id())
    assert len(ids) == 102


def test_chrome_trace_schema_validity(tmp_path):
    p = tmp_path / "exp1.dat"
    p.write_bytes(generate_exp1(64, seed=24).tobytes())
    tf = str(tmp_path / "scan.trace.json")
    port_read(str(p), trace_file=tf, **EXP1_KW)
    doc = json.load(open(tf))
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    for e in doc["traceEvents"]:
        assert e["ph"] in ("X", "i", "M")
        assert isinstance(e["pid"], int)
        if e["ph"] == "M":
            assert e["name"] in ("process_name", "thread_name")
            continue
        assert isinstance(e["name"], str) and e["name"]
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
        args = e["args"]
        assert "span_id" in args and "parent_id" in args


def test_traceview_reads_a_port_trace(tmp_path, exp1_path):
    """``tools/traceview.py`` summarizes a port trace, unchanged."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import traceview

    tf = str(tmp_path / "scan.trace.json")
    port_read(exp1_path, trace_file=tf, **EXP1_KW, **PIPE)
    summary = traceview.summarize(traceview.load_events(tf))
    assert summary


# -- the span tree against the JAX package's --------------------------------

@pytest.mark.parametrize("route", ["sequential", "pipelined_fixed",
                                   "pipelined_rdw", "sharded_rdw"])
def test_span_tree_matches_the_jax_package(tmp_path, exp1_path, exp2_path,
                                           route):
    path, kw = {
        "sequential": (exp1_path, EXP1_KW),
        "pipelined_fixed": (exp1_path, dict(EXP1_KW, **PIPE)),
        "pipelined_rdw": (exp2_path, dict(EXP2_KW, **PIPE)),
        "sharded_rdw": (exp2_path, dict(EXP2_KW,
                                        input_split_records="800")),
    }[route]
    tj, tp = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    want = jax_read(path, trace_file=tj, **kw)
    got = port_read(path, trace_file=tp, **kw)
    assert got.to_arrow().equals(want.to_arrow())
    jax_edges, port_edges = _edges(tj), _edges(tp)
    if route == "sharded_rdw":
        # the port frames the file whole (its window reads inside
        # "frame") and plans no index shards on this route
        assert jax_edges - port_edges == {
            ("plan_index", "phase", "X", "scan/scan"),
            ("read", "stage", "X", "shard/shard")}
        assert port_edges <= jax_edges
    else:
        assert port_edges == jax_edges


# -- Prometheus exposition -------------------------------------------------

def test_prometheus_exposition_format(tmp_path):
    p = tmp_path / "exp1.dat"
    p.write_bytes(generate_exp1(32, seed=25).tobytes())
    port_read(str(p), **EXP1_KW)
    text = cobrix_tpu_torch.prometheus_text()
    assert re.search(r"^# TYPE cobrix_scans_total counter$", text, re.M)
    assert re.search(r"^cobrix_scans_total \d+$", text, re.M)
    assert re.search(r"^# TYPE cobrix_record_length_bytes histogram$",
                     text, re.M)
    assert re.search(
        r'^cobrix_record_length_bytes_bucket\{le="\+Inf"\} \d+$',
        text, re.M)
    assert re.search(r"^cobrix_record_length_bytes_count \d+$", text, re.M)
    assert "cobrix_plan_cache_events_total{" in text
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        assert re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'-?\d+(\.\d+)?([eE][+-]?\d+)?$', line), line


def _families(text):
    return {tuple(line.split()[2:4]) for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metric_names_and_types_match_the_jax_package(exp1_path):
    """The read path's metric set has the JAX package's names, types and
    labels, and a read's exposition in either package carries all of
    it."""
    from cobrix_tpu.obs import metrics as jax_metrics

    def scan_set(module):
        return {(m.name, m.kind, tuple(getattr(m, "label_names", ())))
                for m in module.scan_metrics(
                    module.MetricsRegistry()).values()}
    port_set = scan_set(tobs.metrics)
    assert port_set == scan_set(jax_metrics)
    jax_read(exp1_path, **EXP1_KW)
    port_read(exp1_path, **EXP1_KW)
    families = {(name, kind) for name, kind, _ in port_set}
    assert families <= _families(jax_metrics.prometheus_text())
    assert families <= _families(cobrix_tpu_torch.prometheus_text())


def test_histogram_bucket_cumulativity():
    reg = MetricsRegistry()
    h = reg.histogram("h_test", "t", buckets=(1, 2, 4))
    for v in (0.5, 1.5, 3, 8, 0.1):
        h.observe(v)
    lines = reg.exposition().splitlines()
    buckets = [int(ln.rsplit(" ", 1)[1]) for ln in lines
               if ln.startswith("h_test_bucket")]
    assert buckets == sorted(buckets)
    assert buckets[-1] == 5
    assert h.quantile(0.5) is not None


# -- live progress ---------------------------------------------------------

def _assert_monotonic(snaps):
    for a, b in zip(snaps, snaps[1:]):
        assert b.bytes_done >= a.bytes_done
        assert b.records_done >= a.records_done
        assert b.chunks_done >= a.chunks_done
        assert b.chunks_failed >= a.chunks_failed
        assert b.elapsed_s >= a.elapsed_s
        assert b.chunks_inflight >= 0


def test_progress_callback_monotonic_pipelined(exp1_path):
    snaps = []
    out = port_read(exp1_path, progress_callback=snaps.append,
                    progress_interval_s="0", **EXP1_KW, **PIPE)
    assert len(snaps) >= 2
    _assert_monotonic(snaps)
    final = snaps[-1]
    assert final.done and final.records_done == len(out)
    assert final.bytes_done == final.bytes_total > 0
    assert final.chunks_done == final.chunks_total >= 2
    assert final.chunks_inflight == 0
    assert final.stage_busy_s.get("decode", 0) > 0


@pytest.mark.parametrize("route", ["sequential_fixed", "pipelined_fixed",
                                   "pipelined_rdw", "sequential_rdw"])
def test_progress_totals_match_the_jax_package(exp1_path, exp2_path, route):
    path, kw = {
        "sequential_fixed": (exp1_path, EXP1_KW),
        "pipelined_fixed": (exp1_path, dict(EXP1_KW, **PIPE)),
        "pipelined_rdw": (exp2_path, dict(EXP2_KW, **PIPE)),
        "sequential_rdw": (exp2_path, dict(EXP2_KW,
                                           input_split_records="800")),
    }[route]
    seen = {"jax": [], "port": []}
    jax_read(path, progress_callback=seen["jax"].append,
             progress_interval_s="0", **kw)
    port_read(path, progress_callback=seen["port"].append,
              progress_interval_s="0", **kw)
    _assert_monotonic(seen["port"])
    j, p = seen["jax"][-1], seen["port"][-1]
    assert p.done and j.done
    assert (p.bytes_total, p.bytes_done, p.records_done, p.chunks_failed,
            p.chunks_inflight) == (j.bytes_total, j.bytes_done,
                                   j.records_done, j.chunks_failed,
                                   j.chunks_inflight)
    if route == "sequential_rdw":
        # the port reads the file whole: one unit of progress, where the
        # JAX package reads its four index shards
        assert (p.chunks_total, p.chunks_done) == (1, 1)
        assert (j.chunks_total, j.chunks_done) == (4, 4)
    else:
        assert (p.chunks_total, p.chunks_done) == (j.chunks_total,
                                                   j.chunks_done)


def test_progress_callback_exception_never_breaks_scan(tmp_path):
    p = tmp_path / "exp1.dat"
    p.write_bytes(generate_exp1(16, seed=28).tobytes())

    def boom(progress):
        raise RuntimeError("broken progress bar")

    out = port_read(str(p), progress_callback=boom, progress_interval_s="0",
                    **EXP1_KW)
    assert len(out) == 16


def test_progress_bytes_reach_total_on_var_len_tail_shard(tmp_path):
    p = tmp_path / "exp2.dat"
    raw = generate_exp2(3000, seed=34)
    p.write_bytes(raw)
    for extra in ({}, PIPE):
        snaps = []
        port_read(str(p), input_split_records="800",
                  progress_callback=snaps.append, progress_interval_s="0",
                  **EXP2_KW, **extra)
        final = snaps[-1]
        assert final.bytes_total == len(raw)
        assert final.bytes_done == final.bytes_total


def test_trace_file_unwritable_fails_before_scan(tmp_path):
    p = tmp_path / "exp1.dat"
    p.write_bytes(generate_exp1(16, seed=35).tobytes())
    with pytest.raises(ValueError, match="trace_file"):
        port_read(str(p), trace_file=str(tmp_path / "no" / "such" / "t.json"),
                  **EXP1_KW)


def test_failed_scan_still_writes_partial_trace_and_final_progress(
        tmp_path):
    p = tmp_path / "bad.dat"
    p.write_bytes(generate_exp1(4, seed=36).tobytes() + b"\x00\x01\x02")
    tf = str(tmp_path / "fail.trace.json")
    snaps = []
    with pytest.raises(ValueError):
        port_read(str(p), trace_file=tf, progress_callback=snaps.append,
                  progress_interval_s="0", **EXP1_KW)
    assert snaps and snaps[-1].done
    doc = json.load(open(tf))
    assert doc["traceEvents"]


@pytest.mark.parametrize("arg,value", [("progress_callback", "nope"),
                                       ("tracer", "nope")])
def test_callbacks_must_be_callable(tmp_path, arg, value):
    p = tmp_path / "exp1.dat"
    p.write_bytes(generate_exp1(16, seed=29).tobytes())
    with pytest.raises(ValueError, match=arg):
        port_read(str(p), **{arg: value}, **EXP1_KW)


def test_progress_tracker_thread_safety():
    tracker = ProgressTracker(lambda p: None, bytes_total=8000,
                              chunks_total=80, min_interval_s=0.0)

    def work():
        for _ in range(20):
            tracker.chunk_started()
            tracker.chunk_done(bytes_done=100, records=10)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tracker.finish()
    snap = tracker.snapshot(done=True)
    assert snap.chunks_done == 80
    assert snap.bytes_done == 8000
    assert snap.records_done == 800


def test_progress_retried_chunk_counts_once_without_tracer():
    from cobrix_tpu_torch.engine.pipeline import PipelineExecutor

    snaps = []
    tracker = ProgressTracker(snaps.append, min_interval_s=0.0)
    failed_once = []

    def flaky(payload):
        if not failed_once:
            failed_once.append(1)
            raise RuntimeError("transient")
        return payload

    ctx = ObsContext(progress=tracker)
    with activate(ctx):
        ex = PipelineExecutor(2, chunk_retries=1)
    results = ex.run([((lambda: 1), flaky), ((lambda: 2), (lambda p: p))])
    assert results == [1, 2]
    snap = tracker.snapshot()
    assert snap.chunks_done == 2
    assert snap.chunks_inflight == 0
    _assert_monotonic(snaps)


def test_retried_chunk_is_an_instant_on_the_trace():
    from cobrix_tpu_torch.engine.pipeline import PipelineExecutor

    tracer = Tracer()
    failed_once = []

    def flaky(payload):
        if not failed_once:
            failed_once.append(1)
            raise RuntimeError("transient")
        return payload

    with activate(ObsContext(tracer=tracer)):
        ex = PipelineExecutor(2, chunk_retries=1)
    assert ex.run([((lambda: 1), flaky)]) == [1]
    names = [(s[2], s[4]) for s in tracer.spans]
    assert ("chunk_retry", "i") in names and ("chunk", "X") in names


# -- tracing-off fast path -------------------------------------------------

def test_tracing_off_zero_allocation_fast_path(tmp_path):
    assert maybe_span(None, "a") is maybe_span(None, "b")
    st = StageTimes()
    with st.timed("read"):
        pass
    assert st.tracer is None
    p = tmp_path / "exp1.dat"
    p.write_bytes(generate_exp1(16, seed=30).tobytes())
    out = port_read(str(p), **EXP1_KW)
    assert out.metrics.spans is None
    assert out.metrics.tracer is None
    assert "span_count" not in out.metrics.as_dict()
    assert out.metrics.stage_busy is None


def test_read_metrics_timings_accumulation_is_locked():
    m = ReadMetrics()
    n_threads, n_iter = 8, 2000

    def work():
        for _ in range(n_iter):
            m.add_timing("scan", 0.001)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert m.timings_s["scan"] == pytest.approx(
        n_threads * n_iter * 0.001, rel=1e-6)


# -- the per-read cache scope ----------------------------------------------

def test_cache_scope_isolated_between_concurrent_reads(tmp_path):
    p1 = tmp_path / "a.dat"
    p2 = tmp_path / "b.dat"
    p1.write_bytes(generate_exp1(32, seed=31).tobytes())
    p2.write_bytes(generate_exp1(32, seed=32).tobytes())
    port_read(str(p1), **EXP1_KW)  # warm caches
    outs = [None, None]

    def read(i, path):
        outs[i] = port_read(path, **EXP1_KW)

    threads = [threading.Thread(target=read, args=(0, str(p1))),
               threading.Thread(target=read, args=(1, str(p2)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for out in outs:
        stats = out.metrics.as_dict()["plan_cache"]
        assert stats["parse_hits"] == 1
        assert stats["parse_misses"] == 0


@pytest.mark.parametrize("route", ["sequential", "pipelined"])
def test_plan_cache_counts_match_the_jax_package(tmp_path, route):
    """A cold read (a copybook neither process has parsed) and a warm
    read count the same hits and misses in both packages."""
    # a copybook text of its own: its first parse is a miss in both
    copybook = EXP1_COPYBOOK + f"\n      * plan-cache probe {route}\n"
    p = tmp_path / "exp1.dat"
    p.write_bytes(generate_exp1(300, seed=33).tobytes())
    kw = dict(copybook_contents=copybook,
              **(dict(PIPE) if route == "pipelined" else {}))
    for temperature in ("cold", "warm"):
        want = jax_read(str(p), **kw).metrics.as_dict()["plan_cache"]
        got = port_read(str(p), **kw).metrics.as_dict()["plan_cache"]
        assert got == want, temperature


def test_obs_context_thread_locality():
    ctx = ObsContext()
    seen = []
    with activate(ctx):
        assert current() is ctx
        t = threading.Thread(target=lambda: seen.append(current()))
        t.start()
        t.join()
    assert seen == [None]
    assert current() is None


def test_carry_enters_the_context_on_another_thread():
    from cobrix_tpu_torch.obs.context import carry

    ctx = ObsContext()
    seen = []
    with activate(ctx):
        fn = carry(lambda: seen.append(current()))
    t = threading.Thread(target=fn)
    t.start()
    t.join()
    assert seen == [ctx]
    # outside a read the target is returned as it is
    plain = (lambda: None)
    assert carry(plain) is plain


def test_tracer_argument_collects_spans_without_a_file(exp1_path):
    tracer = Tracer(trace_id="embedded")
    out = port_read(exp1_path, tracer=tracer, **EXP1_KW, **PIPE)
    assert out.metrics.tracer is tracer
    names = collections.Counter(s[2] for s in out.metrics.spans)
    assert names["chunk"] >= 2 and names["scan"] == 2
    root = [s for s in tracer.spans if s[0] == tracer.root_id][0]
    assert root[9]["trace_id"] == "embedded"
