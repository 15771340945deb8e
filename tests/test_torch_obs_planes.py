"""The port's request-scoped and process planes (``cobrix_tpu_torch.obs``
audit, slo, promparse, metrics; ``utils.pressure``; the I/O counters that
ride the read's observability context), held to the JAX package's:
the obs-unit cases of ``tests/test_request_obs.py`` on the port,
``test_prometheus_counters_accumulate`` of
``tests/test_query_pushdown.py``, and the same inputs through both
packages' copies where a value is compared (SLO specs, audit records,
the parsed exposition).

Left out (the serve tier, ROADMAP A8): the served-scan cases of
``tests/test_request_obs.py`` (`test_streamed_scan_yields_one_merged_trace`,
`test_reserved_option_is_a_protocol_error`,
`test_trace_absent_unless_requested`,
`test_served_scans_reach_the_audit_log`,
`test_served_slo_counters_and_healthz`,
`test_breach_dumps_trace_and_field_costs`, `test_error_scan_dumps_too`,
`TestDebugEndpoints`, `TestDrain`, `TestZeroOverhead`).
"""
import json
import os
import threading

import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.obs import slo as jax_slo
from cobrix_tpu.testing.generators import (EXP1_COPYBOOK,
                                           TRANSDATA_COPYBOOK,
                                           generate_exp1,
                                           generate_transactions)
from cobrix_tpu_torch.obs import (AuditLog, FlightRecorder, ScanRecord,
                                  SloTracker, Tracer, fieldcost,
                                  parse_slo, parse_slos, process_metrics,
                                  read_audit_log, scan_metrics,
                                  update_process_metrics)
from cobrix_tpu_torch.obs import promparse
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow

warm_pyarrow()

FIXED_OPTS = dict(copybook_contents=TRANSDATA_COPYBOOK,
                  schema_retention_policy="collapse_root")


def port_read(path, **kw):
    return cobrix_tpu_torch.read_cobol(path, device="cpu", **kw)


@pytest.fixture(scope="module")
def exp1_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("planes") / "exp1.dat"
    p.write_bytes(generate_exp1(600, seed=7).tobytes())
    return str(p)


@pytest.fixture(scope="module")
def txn_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("planes") / "txn.dat"
    p.write_bytes(bytes(generate_transactions(600, seed=11)))
    return str(p)


# -- trace identity ---------------------------------------------------------

class TestTracePropagation:
    def test_in_process_inbound_trace_context(self, exp1_path, tmp_path):
        trace_path = str(tmp_path / "scan.json")
        port_read(exp1_path, copybook_contents=EXP1_COPYBOOK,
                  trace_file=trace_path, trace_id="inbound-trace",
                  request_id="req-42")
        doc = json.load(open(trace_path))
        assert doc["trace_id"] == "inbound-trace"
        roots = [e for e in doc["traceEvents"]
                 if (e.get("args") or {}).get("trace_id")]
        assert roots and roots[0]["args"]["request_id"] == "req-42"

    def test_tracer_mints_unique_trace_ids(self):
        assert Tracer().trace_id != Tracer().trace_id


# -- the audit log and the flight recorder -----------------------------------

class TestAuditLog:
    def test_rotation_bounds_size(self, tmp_path):
        path = str(tmp_path / "audit.log")
        log = AuditLog(path, max_mb=0.0002, keep=2)
        for i in range(40):
            log.append(ScanRecord(request_id=f"r{i:04d}", trace_id="t",
                                  tenant="a", outcome="ok"))
        names = sorted(os.listdir(tmp_path))
        assert names == ["audit.log", "audit.log.1", "audit.log.2"]
        for name in names:
            assert os.path.getsize(tmp_path / name) <= 300
        recs = list(read_audit_log(path, include_rotated=True))
        assert recs[-1].request_id == "r0039"
        assert all(r.tenant == "a" for r in recs)

    def test_malformed_lines_are_skipped(self, tmp_path):
        path = str(tmp_path / "audit.log")
        log = AuditLog(path)
        log.append(ScanRecord(request_id="good", trace_id="t",
                              tenant="a", outcome="ok"))
        with open(path, "a") as f:
            f.write("NOT JSON\n{\"half\": \n")
        log.append(ScanRecord(request_id="good2", trace_id="t",
                              tenant="a", outcome="ok"))
        assert [r.request_id for r in read_audit_log(path)] == \
            ["good", "good2"]

    def test_records_read_back_in_the_jax_package(self, tmp_path):
        """A log the port writes is the JAX package's format: its reader
        returns the same records."""
        from cobrix_tpu.obs.audit import read_audit_log as jax_read_log

        path = str(tmp_path / "audit.log")
        log = AuditLog(path)
        for i in range(3):
            log.append(ScanRecord(request_id=f"r{i}", trace_id="t",
                                  tenant="a", outcome="ok", e2e_s=0.5 * i))
        port = [r.__dict__ for r in read_audit_log(path)]
        jax = [r.__dict__ for r in jax_read_log(path)]
        assert port == jax and len(port) == 3


class TestFlightRecorder:
    def test_ring_and_dump_unit(self, tmp_path):
        fr = FlightRecorder(ring_size=3, dump_dir=str(tmp_path))
        healthy = ScanRecord(request_id="h", trace_id="t", tenant="a",
                             outcome="ok")
        assert fr.observe(healthy) is None
        tracer = Tracer(trace_id="dump-trace")
        with tracer.span("decode"):
            pass
        bad = ScanRecord(request_id="slow1", trace_id="dump-trace",
                         tenant="a", outcome="ok",
                         slo_breaches=["first_batch_p99"])
        dump = fr.observe(bad, tracer=tracer,
                          field_costs={"F1": {"decode_s": 0.5}})
        assert dump and os.path.isdir(dump)
        assert bad.dump_path == dump
        trace = json.load(open(os.path.join(dump, "trace.json")))
        assert trace["trace_id"] == "dump-trace"
        costs = json.load(open(os.path.join(dump, "field_costs.json")))
        assert costs["F1"]["decode_s"] == 0.5
        for i in range(5):
            fr.observe(ScanRecord(request_id=f"r{i}", trace_id="t",
                                  tenant="a", outcome="ok"))
        recent = fr.recent(10)
        assert [r.request_id for r in recent] == ["r4", "r3", "r2"]
        assert fr.recent(10, outcome="bad") == []


# -- service-level objectives ------------------------------------------------

class TestSlo:
    def test_parse_specs(self):
        slo = parse_slo("first_batch_p99=0.5")
        assert (slo.kind, slo.threshold, slo.objective) == \
            ("first_batch", 0.5, 0.99)
        assert parse_slo("e2e_p95=3").objective == 0.95
        assert parse_slo("roofline_min=0.05").kind == "roofline"
        assert parse_slo("error_rate=0.01").objective == 0.99
        for bad in ("p99=1", "first_batch=1", "roofline_min=2",
                    "error_rate=1.5", "e2e_p999=1"):
            with pytest.raises(ValueError):
                parse_slo(bad)
        with pytest.raises(ValueError):
            parse_slos(["error_rate=0.1", "error_rate=0.2"])

    @pytest.mark.parametrize("spec", [
        "first_batch_p99=0.5", "e2e_p95=3", "roofline_min=0.05",
        "error_rate=0.01", "e2e_p50=0.25"])
    def test_specs_parse_as_in_the_jax_package(self, spec):
        got, want = parse_slo(spec), jax_slo.parse_slo(spec)
        assert (got.name, got.kind, got.threshold, got.objective) == \
            (want.name, want.kind, want.threshold, want.objective)

    def test_evaluation_matrix(self):
        slos = parse_slos(["first_batch_p99=0.1", "e2e_p95=1.0",
                           "roofline_min=0.5", "error_rate=0.01"])
        tracker = SloTracker(slos)

        def rec(**kw):
            base = dict(request_id="r", trace_id="t",
                        tenant="torch-matrix", outcome="ok")
            base.update(kw)
            return ScanRecord(**base)

        assert tracker.observe(rec(first_batch_s=0.05, e2e_s=0.5,
                                   roofline_fraction=0.9)) == []
        assert tracker.observe(rec(first_batch_s=0.5, e2e_s=0.5,
                                   roofline_fraction=0.9)) == \
            ["first_batch_p99"]
        breaches = tracker.observe(rec(outcome="error"))
        assert set(breaches) == {"first_batch_p99", "e2e_p95",
                                 "roofline_min", "error_rate"}
        assert tracker.observe(rec(outcome="rejected")) == []
        assert tracker.observe(rec(outcome="client_gone")) == []
        assert tracker.observe(rec()) == []
        status = tracker.status()
        assert status["first_batch_p99"]["good"] == 1
        assert status["first_batch_p99"]["bad"] == 2
        assert status["first_batch_p99"]["burning"] is True
        assert status["error_rate"]["good"] == 3


# -- the metrics registry and its exposition ---------------------------------

def test_process_gauges():
    update_process_metrics(open_scans=0)
    text = cobrix_tpu_torch.prometheus_text()
    assert "cobrix_process_uptime_seconds" in text
    assert "cobrix_serve_open_scans 0" in text
    rss = [line for line in text.splitlines()
           if line.startswith("cobrix_process_rss_bytes ")]
    assert float(rss[0].split()[1]) > 1e6
    assert set(process_metrics()) == {"uptime", "rss", "open_scans"}


def test_exposition_passes_the_validator(exp1_path, txn_path):
    port_read(exp1_path, copybook_contents=EXP1_COPYBOOK,
              pipeline_workers="2", chunk_size_mb="0.2")
    port_read(txn_path, filter="CURRENCY == 'USD'", **FIXED_OPTS)
    text = cobrix_tpu_torch.prometheus_text()
    assert promparse.validate_text(text) == []
    families = promparse.parse_text(text)
    assert families["cobrix_scans_total"].kind == "counter"
    assert families["cobrix_chunk_latency_seconds"].kind == "histogram"
    # the JAX package's parser reads the port's exposition the same way
    from cobrix_tpu.obs import promparse as jax_promparse

    theirs = jax_promparse.parse_text(text)
    assert sorted(theirs) == sorted(families)
    assert promparse.render(families) == jax_promparse.render(theirs)


def test_prometheus_counters_accumulate(txn_path):
    m = scan_metrics()
    before = m["records_pruned"].value(depth="filter")
    data = port_read(txn_path, filter="CURRENCY == 'USD'", **FIXED_OPTS)
    after = m["records_pruned"].value(depth="filter")
    assert after - before == data.metrics.pushdown["records_pruned_filter"]


def test_scan_totals_reach_the_registry(exp1_path):
    m = scan_metrics()
    scans, records = m["scans"].value(), m["records"].value()
    lengths = m["record_length"].snapshot()["count"]
    out = port_read(exp1_path, copybook_contents=EXP1_COPYBOOK)
    assert m["scans"].value() == scans + 1
    assert m["records"].value() == records + len(out)
    assert m["record_length"].snapshot()["count"] - lengths == len(out)
    assert m["cache"].value(cache="decoder", result="hits") + \
        m["cache"].value(cache="decoder", result="misses") >= 1


def test_corruption_counter_is_on_the_registry():
    from cobrix_tpu_torch.io.integrity import (corruption_counter,
                                               note_corruption)

    c = corruption_counter()
    before = c.value("roofline")
    assert c.value(plane="roofline") == before
    # outside a read a detection goes straight to the registry
    note_corruption("roofline", "/nowhere", "test")
    assert c.value("roofline") == before + 1
    assert 'cobrix_cache_corruption_total{plane="roofline"}' in \
        cobrix_tpu_torch.prometheus_text()


# -- the memory-pressure degrade ---------------------------------------------

def test_pipeline_degrades_under_pressure(exp1_path):
    """Past the degrade watermark the pipeline's reader halves its
    in-flight window (the report counts it); the read is unchanged. No
    budget, no degrade."""
    from cobrix_tpu_torch.utils import pressure

    kw = dict(copybook_contents=EXP1_COPYBOOK, pipeline_workers="2",
              chunk_size_mb="0.2")
    plain = port_read(exp1_path, **kw)
    assert "pressure_degrades" not in plain.metrics.pipeline
    pressure.set_process_budget(100, rss_fn=lambda: 80)
    try:
        assert pressure.current_level() == pressure.LEVEL_DEGRADED
        degraded = port_read(exp1_path, **kw)
    finally:
        pressure.set_process_budget(0)
    assert pressure.current_level() == pressure.LEVEL_OK
    assert degraded.to_arrow().equals(plain.to_arrow())
    assert degraded.metrics.pipeline.get("pressure_degrades", 0) >= 1


# -- the I/O counters on the read's context -----------------------------------

def test_io_counters_ride_the_context_onto_pool_threads(tmp_path):
    """A backend read with read-ahead: the prefetch pool's fetches count
    into the read's IoStats through the context they carry, and the
    io dict equals the JAX package's."""
    from cobrix_tpu.reader import stream as jax_stream
    from cobrix_tpu_torch.reader import stream as port_stream

    data = generate_exp1(300, seed=5).tobytes()

    def register(module, base):
        class Source(base):
            def __init__(self, url):
                self.url = url

            def size(self):
                return len(data)

            def read(self, offset, n):
                return data[offset:offset + n]

        module.register_stream_backend("obsmem", Source)

    register(port_stream, port_stream.ByteRangeSource)
    register(jax_stream, jax_stream.ByteRangeSource)
    opts = dict(copybook_contents=EXP1_COPYBOOK, io_block_mb="0.05",
                prefetch_blocks="3")
    got = port_read("obsmem://exp1", **opts)
    want = cobrix_tpu.read_cobol("obsmem://exp1", backend="numpy",
                                 parallelism="1", **opts)
    assert got.to_arrow().equals(want.to_arrow())
    gio, wio = got.metrics.as_dict()["io"], want.metrics.as_dict()["io"]
    assert gio["prefetch_issued"] > 0
    assert gio["bytes_fetched"] == wio["bytes_fetched"] == len(data)


def test_no_timer_calls_without_attribution(exp1_path):
    before = fieldcost.timer_calls()
    out = port_read(exp1_path, copybook_contents=EXP1_COPYBOOK,
                    pipeline_workers="2", chunk_size_mb="0.2")
    out.to_arrow()
    assert fieldcost.timer_calls() == before


def test_concurrent_reads_keep_their_own_io_counters(tmp_path):
    import gzip

    raw = generate_exp1(200, seed=3).tobytes()
    paths = []
    for i in range(2):
        p = tmp_path / f"f{i}.dat.gz"
        p.write_bytes(gzip.compress(raw[: (i + 1) * 1493 * 80]))
        paths.append(str(p))
    outs = [None, None]

    def read(i):
        outs[i] = port_read(paths[i], copybook_contents=EXP1_COPYBOOK)

    threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, out in enumerate(outs):
        io = out.metrics.as_dict()["io"]
        # each read inflated its own feed (twice without a cache_dir:
        # the sizing pass and the read)
        assert io["decompressed_bytes_out"] == 2 * (i + 1) * 1493 * 80
