"""The port's scan explain, per-field cost attribution and roofline
(``cobrix_tpu_torch.explain``, ``obs.fieldcost``, ``obs.roofline``),
held to the JAX package's: the single-process cases of
``tests/test_explain.py`` on the port, ``TestExplain`` of
``tests/test_query_pushdown.py``, and, on the same copybooks and bytes
through both packages (JAX ``backend="numpy"``, port ``device="cpu"``),
the report's structure value for value — the copybook summary, the
fields table, the pushdown section and the execution plan's keys (the
port's ``device`` where the JAX package has ``backend``) — and the set
of field-cost keys and kernel labels.

Timings are held as the JAX tests hold them, never compared as values:
the decode plane sums to within 15% of the decode stage's busy time (on
the CPU's plain versions here; ``chip_smoke.py`` phase 17 holds it on
the card). Left out (ROADMAP A7): `test_multihost_shard_merge`.
"""
import json
import os
import subprocess
import sys
import time

import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.explain import explain as jax_explain
from cobrix_tpu.testing.generators import (EXP1_COPYBOOK, EXP3_COPYBOOK,
                                           TRANSDATA_COPYBOOK,
                                           generate_exp1, generate_exp3,
                                           generate_transactions)
from cobrix_tpu_torch import ScanReport, explain
from cobrix_tpu_torch.obs import fieldcost, roofline
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow

from util import hard_timeout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

warm_pyarrow()

VRL_COPYBOOK = """
       01  TRANSACTION.
           05  TXN-ID        PIC 9(4) COMP.
           05  AMOUNT        PIC S9(7)V99 COMP-3.
           05  COUNTER       PIC 9(6).
           05  NAME          PIC X(12).
"""
FIXED_OPTS = dict(copybook_contents=TRANSDATA_COPYBOOK,
                  schema_retention_policy="collapse_root")
VRL_OPTS = dict(is_record_sequence="true", segment_field="SEGMENT_ID",
                schema_retention_policy="collapse_root",
                redefine_segment_id_map="STATIC-DETAILS => C",
                **{"redefine-segment-id-map:1": "CONTACTS => P"})
PIPE = dict(pipeline_workers="2", chunk_size_mb="0.8")


def port_read(path, **kw):
    return cobrix_tpu_torch.read_cobol(path, device="cpu", **kw)


def jax_read(path, **kw):
    return cobrix_tpu.read_cobol(path, backend="numpy",
                                 **dict(kw, parallelism="1"))


def _rdw_file(n_records: int) -> bytes:
    """Plain RDW stream of VRL_COPYBOOK records (no segments)."""
    from cobrix_tpu_torch.testing.generators import _rdw

    chunks = []
    for i in range(n_records):
        body = (
            (i % 9999).to_bytes(2, "big")
            + bytes([0x01, 0x23, 0x45, 0x67, (i % 10) * 16 + 0x0C])
            + f"{i % 999999:06d}".encode("cp037")
            + f"NAME{i % 97:04d}    ".encode("cp037")
        )
        chunks.append(_rdw(len(body)) + body)
    return b"".join(chunks)


@pytest.fixture()
def exp1_file(tmp_path):
    path = tmp_path / "exp1.dat"
    path.write_bytes(generate_exp1(2000, seed=17).tobytes())
    return str(path)


@pytest.fixture(scope="module")
def txn_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("explain") / "txn.dat"
    path.write_bytes(bytes(generate_transactions(600, seed=11)))
    return str(path)


def _costs_of(report):
    costs = report.field_costs
    assert costs, "attribution produced no field costs"
    return costs


def _totals(costs):
    return {k: (v["bytes"], v["values"]) for k, v in costs.items()}


# -- explain without a scan -------------------------------------------------

class TestExplainPreScan:
    def test_no_data_file_needed(self):
        rep = explain(copybook_contents=EXP1_COPYBOOK, device="cpu")
        assert isinstance(rep, ScanReport)
        assert rep.data is None and rep.field_costs is None
        assert rep.copybook["record_size"] == 1493
        assert rep.copybook["fields"] > 100
        assert all({"offset", "width", "codec"} <= set(f)
                   for f in rep.fields)
        offsets = [f["offset"] for f in rep.fields]
        assert offsets == sorted(offsets)
        assert rep.groups and all(
            {"codec", "width", "columns"} <= set(g) for g in rep.groups)
        assert set(rep.cache_planes) == {
            "copybook_parse", "field_plan", "code_page_lut", "decoder",
            "block", "index"}
        for row in rep.cache_planes.values():
            assert row["status"] in ("hit", "miss", "cold", "off")
        assert rep.cache_planes["block"]["status"] == "off"
        text = rep.render()
        assert "copybook:" in text and "cache planes:" in text

    def test_warm_process_reports_hits(self):
        explain(copybook_contents=VRL_COPYBOOK, device="cpu")
        rep = explain(copybook_contents=VRL_COPYBOOK, device="cpu")
        assert rep.cache_planes["copybook_parse"]["status"] == "hit"

    def test_vrl_mode_and_select(self):
        rep = explain(copybook_contents=VRL_COPYBOOK, device="cpu",
                      is_record_sequence="true", select="AMOUNT,TXN-ID")
        assert rep.plan["mode"] == "variable-length"
        assert rep.plan["chunking"] == "sparse-index driven"
        assert {f["field"] for f in rep.fields} == {"TXN_ID", "AMOUNT"}

    def test_as_dict_round_trips_json(self):
        rep = explain(copybook_contents=VRL_COPYBOOK, device="cpu")
        doc = json.loads(json.dumps(rep.as_dict()))
        assert doc["copybook"]["record_size"] > 0
        assert doc["plan"]["mode"] == "fixed-length"
        assert doc["plan"]["device"] == "cpu"

    def test_defaults_to_the_card(self):
        import torch

        if torch.cuda.is_available():
            assert explain(copybook_contents=VRL_COPYBOOK).plan[
                "device"].startswith("cuda")
            return
        with pytest.raises(RuntimeError, match="device='cpu'"):
            explain(copybook_contents=VRL_COPYBOOK)


def _strip(doc):
    """An explain dict's deterministic structure: the copybook summary,
    the fields table, the kernel groups, the pushdown section and the
    execution plan (its device key named as the JAX package's)."""
    plan = dict(doc["plan"])
    plan["backend"] = plan.pop("device", None)
    return (doc["copybook"], doc["fields"], doc["kernel_groups"],
            doc.get("pushdown"), sorted(plan))


@pytest.mark.parametrize("case", ["exp1", "vrl_select", "filter_select",
                                  "exp3_filter"])
def test_prescan_report_matches_the_jax_package(case, tmp_path):
    kw = {
        "exp1": dict(copybook_contents=EXP1_COPYBOOK),
        "vrl_select": dict(copybook_contents=VRL_COPYBOOK,
                           is_record_sequence="true",
                           select="AMOUNT,TXN-ID"),
        "filter_select": dict(FIXED_OPTS, select="CURRENCY,AMOUNT",
                              filter="CURRENCY == 'USD'"),
        "exp3_filter": dict(VRL_OPTS, copybook_contents=EXP3_COPYBOOK,
                            select="COMPANY_ID",
                            filter="segment('C') and TAXPAYER_TYPE == 'A'"),
    }[case]
    want = jax_explain(**kw).as_dict()
    got = explain(device="cpu", **kw).as_dict()
    assert _strip(got) == _strip(want)
    assert want["plan"]["backend"] == "numpy"
    assert {k: v for k, v in got["plan"].items() if k != "device"} == \
        {k: v for k, v in want["plan"].items() if k != "backend"}


def test_postscan_report_matches_the_jax_package(txn_file):
    kw = dict(FIXED_OPTS, filter="CURRENCY == 'USD'", select="CURRENCY")
    want = cobrix_tpu.read_cobol(txn_file, backend="numpy", explain=True,
                                 parallelism="1", **kw)
    got = port_read(txn_file, explain=True, **kw)
    assert got.data.to_arrow().equals(want.data.to_arrow())
    w, g = want.as_dict(), got.as_dict()
    assert _strip(g) == _strip(w)
    assert g["pushdown"]["measured"] == w["pushdown"]["measured"]
    assert (g["records"], g["bytes_read"]) == (w["records"],
                                               w["bytes_read"])


# -- attribution parity + the decode-stage anchor ---------------------------

class TestAttributionParity:
    def test_fixed_sequential_vs_pipelined(self, exp1_file):
        rep_seq = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK,
                            explain=True)
        t_seq = rep_seq.data.to_arrow()
        rep_pipe = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK,
                             explain=True, **PIPE)
        t_pipe = rep_pipe.data.to_arrow()
        assert t_seq.equals(t_pipe)
        costs_seq, costs_pipe = _costs_of(rep_seq), _costs_of(rep_pipe)
        # same field set, byte-identical deterministic components
        assert set(costs_seq) == set(costs_pipe)
        assert _totals(costs_seq) == _totals(costs_pipe)
        assert all(v["busy_s"] > 0 for v in costs_seq.values())
        assert rep_pipe.metrics.pipeline["chunks"] > 1

    @pytest.mark.parametrize("mode", ["sequential", "pipelined"])
    def test_decode_plane_tracks_decode_stage(self, exp1_file, mode):
        kw = PIPE if mode == "pipelined" else {}
        rep = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK,
                        explain=True, **kw)
        rep.data.to_arrow()
        stage = rep.decode_busy_s()
        attributed = rep.attributed_decode_s()
        assert stage and stage > 0
        # the acceptance bound: per-field decode busy sums to within 15%
        # of the measured decode-stage busy time
        assert attributed == pytest.approx(stage, rel=0.15)
        table = rep.as_dict()["field_costs"]
        assert sum(v["assemble_s"] for v in table.values()) > 0

    @pytest.mark.parametrize("mode", ["sequential", "pipelined"])
    def test_decode_plane_tracks_decode_stage_rdw(self, tmp_path, mode):
        path = tmp_path / "txn.rdw"
        path.write_bytes(_rdw_file(6000))
        kw = dict(copybook_contents=VRL_COPYBOOK, is_record_sequence="true")
        if mode == "pipelined":
            kw.update(pipeline_workers="2", chunk_size_mb="0.05")
        rep = port_read(str(path), explain=True, **kw)
        stage = rep.decode_busy_s()
        assert stage and stage > 0
        assert rep.attributed_decode_s() == pytest.approx(stage, rel=0.15)

    def test_vrl_sequential_vs_pipelined(self, tmp_path):
        path = tmp_path / "txn.rdw"
        path.write_bytes(_rdw_file(4000))
        kw = dict(copybook_contents=VRL_COPYBOOK, is_record_sequence="true")
        rep_seq = port_read(str(path), explain=True, **kw)
        t_seq = rep_seq.data.to_arrow()
        rep_pipe = port_read(str(path), explain=True, pipeline_workers="2",
                             chunk_size_mb="0.02", **kw)
        t_pipe = rep_pipe.data.to_arrow()
        assert t_seq.equals(t_pipe)
        costs_seq, costs_pipe = _costs_of(rep_seq), _costs_of(rep_pipe)
        assert set(costs_seq) == set(costs_pipe)
        assert _totals(costs_seq) == _totals(costs_pipe)
        assert {"TXN_ID", "AMOUNT", "COUNTER", "NAME"} <= set(costs_seq)

    def test_duplicate_leaf_names_stay_distinct(self, tmp_path):
        cb = """
       01  REC.
           05  GRP-A.
               10  AMT   PIC 9(4).
           05  GRP-B.
               10  AMT   PIC S9(5) COMP-3.
"""
        recs = b"".join(
            f"{i % 9999:04d}".encode("cp037") + bytes([0x01, 0x23, 0x4C])
            for i in range(500))
        path = tmp_path / "dup.dat"
        path.write_bytes(recs)
        rep = port_read(str(path), copybook_contents=cb, explain=True)
        rep.data.to_arrow()
        costs = _costs_of(rep)
        assert "AMT" not in costs
        by_suffix = {k.rsplit(".", 2)[-2]: v for k, v in costs.items()
                     if k.endswith(".AMT")}
        assert set(by_suffix) == {"GRP_A", "GRP_B"}
        assert by_suffix["GRP_A"]["kernel"] != by_suffix["GRP_B"]["kernel"]

    def test_trace_refreshed_after_lazy_assembly(self, tmp_path):
        cb = """
       01  REC.
           05  NAME  PIC X(10).
"""
        path = tmp_path / "names.dat"
        path.write_bytes(b"".join(
            f"NAME{i:06d}".encode("cp037") for i in range(2000)))
        trace_path = str(tmp_path / "scan.trace.json")
        out = port_read(str(path), copybook_contents=cb,
                        field_costs="true", trace_file=trace_path)
        out.to_arrow()
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import traceview

        with open(trace_path, encoding="utf-8") as f:
            costs = traceview.find_field_costs(json.load(f))
        assert costs and costs["NAME"]["assemble_s"] > 0

    def test_top_fields_and_report_embedding(self, exp1_file):
        rep = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK,
                        explain=True)
        rep.data.to_arrow()
        top = rep.top_fields(5)
        assert len(top) == 5
        assert top == sorted(top, key=lambda r: -r["busy_s"])
        assert {"field", "kernel", "busy_s", "bytes", "values"} <= \
            set(top[0])
        doc = rep.as_dict()
        assert doc["top_fields"] == top
        assert "field costs" in rep.render()
        assert rep.data.metrics.as_dict()["field_costs"] == \
            rep.field_costs


@pytest.mark.parametrize("case", ["exp1", "exp1_pipelined", "vrl", "dup"])
def test_field_cost_keys_and_labels_match_the_jax_package(tmp_path, case):
    """The same copybook and bytes attribute the same fields, with the
    same kernel labels, in both packages (once each read's table is
    built)."""
    if case.startswith("exp1"):
        path = tmp_path / "exp1.dat"
        path.write_bytes(generate_exp1(600, seed=19).tobytes())
        kw = dict(copybook_contents=EXP1_COPYBOOK)
        if case == "exp1_pipelined":
            kw.update(pipeline_workers="2", chunk_size_mb="0.2")
    elif case == "vrl":
        path = tmp_path / "txn.rdw"
        path.write_bytes(_rdw_file(1500))
        kw = dict(copybook_contents=VRL_COPYBOOK, is_record_sequence="true")
    else:
        path = tmp_path / "dup.dat"
        path.write_bytes(b"".join(
            f"{i % 9999:04d}".encode("cp037") + bytes([0x01, 0x23, 0x4C])
            for i in range(300)))
        kw = dict(copybook_contents="""
       01  REC.
           05  GRP-A.
               10  AMT   PIC 9(4).
           05  GRP-B.
               10  AMT   PIC S9(5) COMP-3.
""")
    want = jax_read(str(path), field_costs="true", **kw)
    got = port_read(str(path), field_costs="true", **kw)
    assert got.to_arrow().equals(want.to_arrow())
    w, g = want.metrics.field_costs, got.metrics.field_costs
    assert set(g) == set(w)
    assert {k: v["kernel"] for k, v in g.items()} == \
        {k: v["kernel"] for k, v in w.items()}


# -- disabled => zero timestamps on the hot path ----------------------------

class TestDisabledOverhead:
    @pytest.mark.parametrize("kw", [{}, PIPE],
                             ids=["sequential", "pipelined"])
    def test_no_timer_calls_when_disabled(self, exp1_file, kw):
        before = fieldcost.timer_calls()
        out = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK, **kw)
        out.to_arrow()
        out.to_rows()
        assert fieldcost.timer_calls() == before
        assert out.metrics.as_dict().get("field_costs") is None

    def test_option_enables_without_explain(self, exp1_file):
        before = fieldcost.timer_calls()
        out = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK,
                        field_costs="true")
        out.to_arrow()
        assert fieldcost.timer_calls() > before
        assert out.metrics.as_dict()["field_costs"]


# -- roofline calibration + anchoring ----------------------------------------

class TestRoofline:
    @pytest.fixture()
    def roofline_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("COBRIX_TPU_TORCH_ROOFLINE_CACHE",
                           str(tmp_path / "roofline.json"))
        roofline._memo = None
        yield str(tmp_path / "roofline.json")
        roofline._memo = None

    def test_calibration_caches_and_anchors(self, roofline_cache,
                                            exp1_file):
        assert roofline.cached_bandwidth() is None
        bw = roofline.measured_bandwidth(size_mb=4.0)
        assert bw > 1e8
        assert os.path.exists(roofline_cache)
        roofline._memo = None
        assert roofline.cached_bandwidth() == pytest.approx(bw)
        assert roofline.roofline_fraction(bw / 2) == pytest.approx(
            0.5, rel=0.01)
        out = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK)
        roof = out.metrics.as_dict().get("roofline")
        # the plain versions on a busy CPU can read slowly enough that
        # the 4-decimal fraction rounds to 0, so it is held to the read's
        # own bytes and scan seconds
        rate = out.metrics.bytes_read / out.metrics.timings_s["scan"]
        assert roof and roof["fraction"] == round(rate / bw, 4) and \
            roof["bandwidth_GBps"] == pytest.approx(bw / 1e9, rel=0.01)
        assert "cobrix_roofline_fraction" in \
            cobrix_tpu_torch.prometheus_text()

    def test_later_external_calibration_is_picked_up(self, roofline_cache):
        assert roofline.cached_bandwidth() is None
        roofline._write_cache({"bandwidth_bytes_per_s": 5e9,
                               "method": roofline._METHOD})
        assert roofline.cached_bandwidth() == pytest.approx(5e9)

    def test_corrupt_calibration_quarantined(self, roofline_cache):
        from cobrix_tpu_torch.io.integrity import corruption_counter

        roofline._write_cache({"bandwidth_bytes_per_s": 5e9,
                               "method": roofline._METHOD})
        raw = open(roofline_cache, "rb").read()
        flip = raw.replace(b"5000000000", b"9000000000")
        assert flip != raw
        with open(roofline_cache, "wb") as f:
            f.write(flip)
        before = corruption_counter().value(plane="roofline")
        assert roofline.cached_bandwidth() is None
        assert corruption_counter().value(plane="roofline") == before + 1
        assert not os.path.exists(roofline_cache)

    def test_the_packages_never_share_a_calibration(self, roofline_cache,
                                                    monkeypatch, tmp_path):
        """Each package has its own cache file: the JAX package's
        variable does not move the port's, and the default paths
        differ."""
        from cobrix_tpu.obs import roofline as jax_roofline

        monkeypatch.setenv("COBRIX_ROOFLINE_CACHE",
                           str(tmp_path / "jax-roofline.json"))
        assert roofline.cache_path() == roofline_cache
        assert jax_roofline.cache_path() != roofline.cache_path()
        monkeypatch.delenv("COBRIX_ROOFLINE_CACHE")
        monkeypatch.delenv("COBRIX_TPU_TORCH_ROOFLINE_CACHE")
        assert jax_roofline.cache_path() != roofline.cache_path()
        assert "cobrix_tpu_torch" in roofline.cache_path()

    def test_uncalibrated_reports_none(self, roofline_cache, exp1_file):
        out = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK)
        assert out.metrics.as_dict().get("roofline") is None
        assert roofline.roofline_fraction(1e9) is None


# -- traceview --fields, atomic trace export --------------------------------

class TestTraceviewFields:
    def test_fields_from_trace_and_metrics(self, exp1_file, tmp_path):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import traceview

        trace_path = str(tmp_path / "scan.trace.json")
        out = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK,
                        field_costs="true", trace_file=trace_path)
        out.to_arrow()
        with open(trace_path, encoding="utf-8") as f:
            doc = json.load(f)
        costs = traceview.find_field_costs(doc)
        assert costs and all("busy_s" in v for v in costs.values())
        traceview.print_fields(costs, top_n=3)
        wrapped = {"exp1": {"read_metrics": out.metrics.as_dict()}}
        assert traceview.find_field_costs(wrapped)

    def test_fields_cli(self, exp1_file, tmp_path):
        artifact = tmp_path / "metrics.json"
        out = port_read(exp1_file, copybook_contents=EXP1_COPYBOOK,
                        field_costs="true")
        out.to_arrow()
        artifact.write_text(json.dumps(out.metrics.as_dict()))
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "traceview.py"),
             "--fields", str(artifact)],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "field" in proc.stdout


_KILL_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from cobrix_tpu_torch.obs.trace import Tracer

path = sys.argv[1]
tracer = Tracer()
for i in range(120000):
    tracer.record_span(f"s{{i}}", "stage", 0.0, 1.0,
                       args={{"k": "x" * 40}})
tracer.finish_root()
print("ready", flush=True)
while True:
    tracer.write_chrome_trace(path)
"""


class TestAtomicTraceExport:
    def test_kill_mid_write_never_truncates(self, tmp_path):
        path = str(tmp_path / "scan.trace.json")
        script = tmp_path / "writer.py"
        script.write_text(_KILL_SCRIPT.format(repo=REPO))
        with hard_timeout(120, "atomic trace kill"):
            proc = subprocess.Popen([sys.executable, str(script), path],
                                    stdout=subprocess.PIPE, text=True)
            try:
                assert proc.stdout.readline().strip() == "ready"
                time.sleep(1.0)
                proc.kill()
                proc.wait(timeout=30)
            finally:
                if proc.poll() is None:
                    proc.kill()
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            assert "traceEvents" in doc

    def test_failed_write_leaves_no_temp(self, tmp_path, monkeypatch):
        from cobrix_tpu_torch.obs.trace import Tracer

        tracer = Tracer()
        tracer.record_span("s", "stage", 0.0, 1.0)
        target_dir = tmp_path / "out"
        target_dir.mkdir()
        monkeypatch.setattr(os, "replace",
                            lambda *a, **k: (_ for _ in ()).throw(
                                OSError("disk full")))
        with pytest.raises(OSError):
            tracer.write_chrome_trace(str(target_dir / "t.json"))
        assert list(target_dir.iterdir()) == []


# -- TestExplain of tests/test_query_pushdown.py -----------------------------

class TestExplain:
    def test_prescan_reports_pruning(self):
        rep = explain(copybook_contents=EXP3_COPYBOOK, device="cpu",
                      select="COMPANY_ID",
                      filter="segment('C') and TAXPAYER_TYPE == 'A'",
                      **VRL_OPTS)
        pd = rep.as_dict()["pushdown"]
        assert pd["fields_pruned"] > 0
        assert pd["pre_decode_segment_drop"] == ["C"]
        assert pd["stage1_filter_fields"] == ["TAXPAYER_TYPE"]
        assert pd["late_materialized"] == ["TAXPAYER_TYPE"]
        assert "pushdown" in rep.render()

    def test_postscan_carries_measured_counters(self, txn_file):
        rep = port_read(txn_file, filter="CURRENCY == 'USD'", explain=True,
                        **FIXED_OPTS)
        d = rep.as_dict()
        assert d["pushdown"]["measured"]["records_pruned"] > 0
        assert "measured:" in rep.render()

    def test_postscan_on_an_rdw_file(self, tmp_path):
        path = tmp_path / "exp3.dat"
        path.write_bytes(bytes(generate_exp3(120, seed=11)))
        rep = port_read(str(path), copybook_contents=EXP3_COPYBOOK,
                        filter="segment('C')", explain=True, **VRL_OPTS)
        assert rep.as_dict()["pushdown"]["measured"][
            "records_pruned_segment"] > 0
        assert rep.plan["mode"] == "variable-length"
