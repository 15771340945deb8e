"""The sink's stream drive on the port (`cobrix_tpu_torch.sink_cobol`,
`sink_for_ingestor`), held to the JAX package.

The port of the stream-driven cases of ``tests/test_sink.py``: every
scenario runs through ``cobrix_tpu`` (``backend="numpy"``) and through
``cobrix_tpu_torch`` (``device="cpu"``), each in a directory of its own
with the same layout. Each must leave a dataset whose `read_dataset`
equals the one-shot read of the final sources, and the two packages the
same datasets, the same drive results (batches, records, files) and the
same recovery reports; fsck reports are compared without
``truncated_bytes``, since the manifest records carry their commit
times.
"""
import os

import pytest

pa = pytest.importorskip("pyarrow")

import cobrix_tpu
import cobrix_tpu_torch

from util import hard_timeout

FIXED_COPYBOOK = """
        01  R.
            05  REGION PIC X(2).
            05  KEY    PIC 9(7) COMP.
            05  NAME   PIC X(9).
"""
FIXED_OPTS = {"copybook_contents": FIXED_COPYBOOK}

VRL_COPYBOOK = """
        01  R.
            05  K  PIC X(6).
"""
VRL_OPTS = {"copybook_contents": VRL_COPYBOOK,
            "is_record_sequence": "true",
            "generate_record_id": "true"}

PACKAGES = ("jax", "port")


def fixed_records(n: int, start: int = 0) -> bytes:
    return b"".join(
        ("EU" if i % 3 else "US").encode("cp037")
        + i.to_bytes(4, "big")
        + f"ROW{i % 1000000:06d}".encode("cp037")
        for i in range(start, start + n))


def rdw_records(n: int, start: int = 0) -> bytes:
    out = []
    for i in range(start, start + n):
        payload = f"K{i:05d}".encode("cp037")
        out.append(bytes([0, 0, len(payload) % 256,
                          len(payload) // 256]) + payload)
    return b"".join(out)


def bare(table):
    return table.replace_schema_metadata(None)


def mod(pkg):
    return cobrix_tpu if pkg == "jax" else cobrix_tpu_torch


def kw(pkg):
    return {} if pkg == "jax" else {"device": "cpu"}


def sink(pkg):
    return mod(pkg).sink


def faults(pkg):
    if pkg == "jax":
        from cobrix_tpu.testing import faults as f
    else:
        from cobrix_tpu_torch.testing import faults as f
    return f


def sink_metrics(pkg):
    if pkg == "jax":
        from cobrix_tpu.obs.metrics import sink_metrics as m
    else:
        from cobrix_tpu_torch.obs.metrics import sink_metrics as m
    return m()


def corruption_counter(pkg):
    if pkg == "jax":
        from cobrix_tpu.io.integrity import corruption_counter as c
    else:
        from cobrix_tpu_torch.io.integrity import corruption_counter as c
    return c()


def one_shot(pkg, path, options):
    return bare(mod(pkg).read_cobol(str(path), **kw(pkg),
                                    **options).to_arrow())


def tail(pkg, src, ckpt, options, **k):
    k.setdefault("poll_interval_s", 0.005)
    k.setdefault("idle_timeout_s", 0.1)
    k.setdefault("finalize_on_idle", True)
    k.setdefault("batch_max_mb", 0.01)
    return mod(pkg).tail_cobol(str(src), checkpoint_dir=str(ckpt),
                               **kw(pkg), **options, **k)


def drive_result(res):
    return (res.batches, res.records, res.records_total, res.files,
            {k: v for k, v in res.recovery.items()
             if k != "truncated_bytes"})


def fsck(pkg, ds, **k):
    report = dict(sink(pkg).fsck_sink(str(ds), **k))
    report.pop("truncated_bytes", None)
    return report


def test_empty_dataset_reads_back_schema(tmp_path):
    schemas = []
    for pkg in PACKAGES:
        src = tmp_path / pkg / "in.dat"
        src.parent.mkdir()
        src.write_bytes(fixed_records(10))
        ing = tail(pkg, src, tmp_path / pkg / "ck", FIXED_OPTS)
        s = sink(pkg).sink_for_ingestor(ing, str(tmp_path / pkg / "ds"))
        got = sink(pkg).read_dataset(str(tmp_path / pkg / "ds"))
        assert got.num_rows == 0
        assert got.schema.equals(s.arrow_schema)
        schemas.append((s.arrow_schema, s.schema_fp))
        ing.close()
    assert schemas[0][0].equals(schemas[1][0])
    assert schemas[0][1] == schemas[1][1]


# -- the crash matrix ------------------------------------------------------


def drive_with_kills(pkg, src, ckpt, dataset, fault_dir, options,
                     file_format, kill_points=None, max_cycles=12):
    """Run sink_cobol under a SinkFaultPlan until a run completes; each
    cycle rebuilds the ingestor from the checkpoint exactly like a
    crashed consumer's restart. Returns (kills, the completing drive's
    result)."""
    f = faults(pkg)
    plan = f.SinkFaultPlan(str(fault_dir), action="raise")
    for point in kill_points or f.SINK_KILL_POINTS:
        plan.kill(point)
    cycles = 0
    while True:
        ing = tail(pkg, src, ckpt, options)
        with plan.installed():
            try:
                res = sink(pkg).sink_cobol(ing, str(dataset),
                                           file_format=file_format,
                                           target_file_mb=0.01)
                return cycles, res
            except f.SinkKilled:
                cycles += 1
                ing.close()
        assert cycles < max_cycles, "kill/restart loop did not converge"


@pytest.mark.parametrize("file_format", ["parquet", "arrow"])
@pytest.mark.parametrize("layout", ["fixed", "vrl"])
def test_crash_matrix_byte_identical(tmp_path, file_format, layout):
    """Aborts in EVERY commit window, then restart => dataset
    byte-identical to a one-shot read, with the recovery counters
    advanced, in both packages alike."""
    with hard_timeout(120, "sink crash matrix"):
        payload = (fixed_records(2000) if layout == "fixed"
                   else rdw_records(2000))
        options = FIXED_OPTS if layout == "fixed" else VRL_OPTS
        out = {}
        for pkg in PACKAGES:
            root = tmp_path / pkg
            root.mkdir()
            src = root / "in.dat"
            src.write_bytes(payload)
            m = sink_metrics(pkg)
            recovered = m["recovered_commits"].value()
            quarantined = m["quarantined_files"].value()
            kills, res = drive_with_kills(pkg, src, root / "ck",
                                          root / "ds", root / "faults",
                                          options, file_format)
            assert kills == len(faults(pkg).SINK_KILL_POINTS)
            got = sink(pkg).read_dataset(str(root / "ds"))
            assert got.equals(one_shot(pkg, src, options))
            assert m["recovered_commits"].value() > recovered
            assert m["quarantined_files"].value() > quarantined
            assert fsck(pkg, root / "ds")["clean"]
            out[pkg] = (got, drive_result(res),
                        m["recovered_commits"].value() - recovered,
                        m["quarantined_files"].value() - quarantined)
        assert out["port"][0].equals(out["jax"][0])
        assert out["port"][1:] == out["jax"][1:]


def test_rotation_mid_sink(tmp_path):
    """Source rename-rotation WHILE the sink drives (triggered from the
    on_commit tap): the old generation — including late appends through
    the held descriptor — lands exactly once, then the new one."""
    with hard_timeout(120, "rotation mid-sink"):
        out = {}
        for pkg in PACKAGES:
            root = tmp_path / pkg
            root.mkdir()
            src = root / "app.log"
            src.write_bytes(fixed_records(60))
            state = {"rotated": False}

            def rotate_once(info, pkg=pkg, src=src, state=state):
                if not state["rotated"]:
                    state["rotated"] = True
                    rotated = faults(pkg).rotate_source(
                        str(src), fixed_records(30, 1000))
                    with open(rotated, "ab") as f:
                        f.write(fixed_records(10, 60))

            ing = tail(pkg, src, root / "ck", FIXED_OPTS,
                       idle_timeout_s=0.3, batch_max_mb=0.0005)
            res = sink(pkg).sink_cobol(ing, str(root / "ds"),
                                       on_commit=rotate_once)
            got = sink(pkg).read_dataset(str(root / "ds"))
            keys = sorted(r["KEY"] for r in got.column("R").to_pylist())
            assert keys == list(range(70)) + list(range(1000, 1030))
            assert fsck(pkg, root / "ds")["clean"]
            out[pkg] = (got, drive_result(res))
        assert out["port"][0].equals(out["jax"][0])
        assert out["port"][1] == out["jax"][1]


def test_crash_then_rotation_recovery(tmp_path):
    """A kill mid-sink followed by a rotation BEFORE the restart: the
    recovered consumer drains the relocated old generation through the
    inode/head-CRC alias, exactly once."""
    with hard_timeout(120, "crash+rotation"):
        out = {}
        for pkg in PACKAGES:
            root = tmp_path / pkg
            root.mkdir()
            src = root / "app.log"
            pattern = str(root / "app.log*")
            src.write_bytes(fixed_records(120))
            f = faults(pkg)
            plan = f.SinkFaultPlan(str(root / "faults"), action="raise")
            plan.kill("post_commit", seq=2)
            ing = tail(pkg, pattern, root / "ck", FIXED_OPTS,
                       batch_max_mb=0.0005)
            with plan.installed():
                with pytest.raises(f.SinkKilled):
                    sink(pkg).sink_cobol(ing, str(root / "ds"))
            ing.close()
            f.rotate_source(str(src), fixed_records(40, 5000))
            ing2 = tail(pkg, pattern, root / "ck", FIXED_OPTS,
                        idle_timeout_s=0.3)
            res = sink(pkg).sink_cobol(ing2, str(root / "ds"))
            got = sink(pkg).read_dataset(str(root / "ds"))
            keys = sorted(r["KEY"] for r in got.column("R").to_pylist())
            assert keys == list(range(120)) + list(range(5000, 5040))
            out[pkg] = (got, drive_result(res))
        assert out["port"][0].equals(out["jax"][0])
        assert out["port"][1] == out["jax"][1]


def test_memory_url_dataset_target(tmp_path):
    """The whole protocol — commit, kill, recovery, read-back — over an
    fsspec target (memory://)."""
    pytest.importorskip("fsspec")
    with hard_timeout(120, "memory sink"):
        out = {}
        for pkg in PACKAGES:
            root = tmp_path / pkg
            root.mkdir()
            src = root / "in.dat"
            src.write_bytes(fixed_records(800))
            ds = f"memory://sinktests-port/ds-crash-{pkg}-{os.getpid()}"
            kills, res = drive_with_kills(
                pkg, src, root / "ck", ds, root / "faults", FIXED_OPTS,
                "parquet", kill_points=("post_stage", "post_commit"))
            assert kills == 2
            got = sink(pkg).read_dataset(ds)
            assert got.equals(one_shot(pkg, src, FIXED_OPTS))
            out[pkg] = (got, drive_result(res))
        assert out["port"][0].equals(out["jax"][0])
        assert out["port"][1] == out["jax"][1]


# -- manifest corruption ---------------------------------------------------


def _kill_post_commit(pkg, root, n_records=800):
    """A consumer killed between the manifest append and the ack: the
    canonical unacked-tail state the corruption tests damage."""
    root.mkdir(exist_ok=True)
    src = root / "in.dat"
    src.write_bytes(fixed_records(n_records))
    f = faults(pkg)
    plan = f.SinkFaultPlan(str(root / "faults"), action="raise")
    plan.kill("post_commit", seq=2)
    ing = tail(pkg, src, root / "ck", FIXED_OPTS)
    with plan.installed():
        with pytest.raises(f.SinkKilled):
            sink(pkg).sink_cobol(ing, str(root / "ds"))
    ing.close()
    return src


@pytest.mark.parametrize("mode", ["bitflip", "torn"])
def test_manifest_tail_damage_self_heals(tmp_path, mode):
    """Bit flip / torn tail in the UNACKED manifest region: recovery
    truncates off the checkpointed position, counts plane="sink", and
    the restarted stream converges byte-identically."""
    with hard_timeout(120, "manifest tail damage"):
        out = {}
        for pkg in PACKAGES:
            root = tmp_path / pkg
            src = _kill_post_commit(pkg, root)
            faults(pkg).corrupt_sink_manifest(str(root / "ds"), mode=mode,
                                              which=-1)
            counter = corruption_counter(pkg)
            before = counter.value(plane="sink")
            ing2 = tail(pkg, src, root / "ck", FIXED_OPTS)
            res = sink(pkg).sink_cobol(ing2, str(root / "ds"))
            assert counter.value(plane="sink") > before
            got = sink(pkg).read_dataset(str(root / "ds"))
            assert got.equals(one_shot(pkg, src, FIXED_OPTS))
            out[pkg] = (got, drive_result(res),
                        counter.value(plane="sink") - before)
        assert out["port"][0].equals(out["jax"][0])
        assert out["port"][1:] == out["jax"][1:]


def test_committed_region_damage_is_loud(tmp_path):
    """A bit flip INSIDE the committed (acked) manifest region raises
    structured SinkCorruption, and fsck --repair restores reader
    consistency offline."""
    with hard_timeout(120, "committed-region damage"):
        reports = {}
        for pkg in PACKAGES:
            root = tmp_path / pkg
            root.mkdir()
            src = root / "in.dat"
            src.write_bytes(fixed_records(1500))
            ing = tail(pkg, src, root / "ck", FIXED_OPTS)
            sink(pkg).sink_cobol(ing, str(root / "ds"))
            faults(pkg).corrupt_sink_manifest(str(root / "ds"),
                                              mode="bitflip", which=0)
            counter = corruption_counter(pkg)
            before = counter.value(plane="sink")
            ing2 = tail(pkg, src, root / "ck", FIXED_OPTS)
            with pytest.raises(sink(pkg).SinkCorruption):
                sink(pkg).sink_cobol(ing2, str(root / "ds"))
            ing2.close()
            assert counter.value(plane="sink") > before
            report = fsck(pkg, root / "ds")
            assert not report["clean"]
            assert report["manifest_defect"]
            sink(pkg).fsck_sink(str(root / "ds"), repair=True)
            assert sink(pkg).read_dataset(str(root / "ds")).num_rows == 0
            assert fsck(pkg, root / "ds")["clean"]
            reports[pkg] = report
        assert reports["port"].keys() == reports["jax"].keys()
        assert {k: v for k, v in reports["port"].items()
                if k != "manifest_defect"} \
            == {k: v for k, v in reports["jax"].items()
                if k != "manifest_defect"}


def test_lost_meta_on_nonempty_dataset_is_loud(tmp_path):
    """A missing _sink_meta.json on a NON-empty dataset refuses
    (identity/ownership can't be re-derived)."""
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        src = root / "in.dat"
        src.write_bytes(fixed_records(200))
        ds = root / "ds"
        ing = tail(pkg, src, root / "ck", FIXED_OPTS)
        sink(pkg).sink_cobol(ing, str(ds))
        os.unlink(ds / "_sink_meta.json")
        ing2 = tail(pkg, src, root / "ck", FIXED_OPTS)
        with pytest.raises(sink(pkg).SinkCorruption):
            sink(pkg).sink_cobol(ing2, str(ds))
        ing2.close()


def test_idle_restarts_do_not_loop_recovery(tmp_path):
    """After one genuine recovery, repeated restarts with nothing new to
    commit do no recovery work."""
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        src = _kill_post_commit(pkg, root)
        ing = tail(pkg, src, root / "ck", FIXED_OPTS)
        first = sink(pkg).sink_cobol(ing, str(root / "ds"))
        results = [drive_result(first)]
        for _ in range(2):
            ing = tail(pkg, src, root / "ck", FIXED_OPTS)
            res = sink(pkg).sink_cobol(ing, str(root / "ds"))
            assert res.batches == 0
            assert res.recovery["truncated_commits"] == 0
            assert res.recovery["quarantined_files"] == 0
            assert res.recovery["staged_quarantined"] == 0
            results.append(drive_result(res))
        assert res.recovery["truncated_bytes"] == 0
        got = sink(pkg).read_dataset(str(root / "ds"))
        assert got.equals(one_shot(pkg, src, FIXED_OPTS))
        out[pkg] = (got, results)
    assert out["port"][0].equals(out["jax"][0])
    assert out["port"][1] == out["jax"][1]


def test_ownership_guards_committed_history(tmp_path):
    """Recoveries that would silently discard another producer's
    committed batches refuse loudly instead: a different stream, a
    checkpoint-less rerun, and a one-shot append into a stream-owned
    dataset; a dataset one package's stream owns is guarded against the
    other package's other streams too, and its own stream resumes in
    either package."""
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        src = root / "in.dat"
        src.write_bytes(fixed_records(200))
        ds = root / "ds"
        ing = tail(pkg, src, root / "ck-a", FIXED_OPTS)
        sink(pkg).sink_cobol(ing, str(ds))
        committed = sink(pkg).read_dataset(str(ds))
        assert committed.num_rows == 200
        for other in PACKAGES:
            ing_b = tail(other, src, root / f"ck-b-{other}", FIXED_OPTS)
            with pytest.raises(sink(other).SinkError):
                sink(other).sink_cobol(ing_b, str(ds))
            ing_b.close()
            ing_c = mod(other).tail_cobol(
                str(src), poll_interval_s=0.005, idle_timeout_s=0.1,
                finalize_on_idle=True, **kw(other), **FIXED_OPTS)
            with pytest.raises(sink(other).SinkError):
                sink(other).sink_cobol(ing_c, str(ds))
            ing_c.close()
            with pytest.raises(sink(other).SinkError):
                mod(other).read_cobol(str(src), **kw(other),
                                      **FIXED_OPTS).to_dataset(str(ds))
        assert sink(pkg).read_dataset(str(ds)).equals(committed)
        # the RIGHT stream still resumes cleanly, in either package
        for other in PACKAGES:
            ing_a2 = tail(other, src, root / "ck-a", FIXED_OPTS)
            res = sink(other).sink_cobol(ing_a2, str(ds))
            assert res.batches == 0
            assert sink(pkg).read_dataset(str(ds)).equals(committed)


def test_stream_resumes_across_packages(tmp_path):
    """A stream killed after a commit in one package is recovered and
    finished by the other: the dataset equals the one-shot read."""
    with hard_timeout(120, "cross-package sink"):
        for first, second in (("jax", "port"), ("port", "jax")):
            root = tmp_path / first
            src = _kill_post_commit(first, root)
            ing = tail(second, src, root / "ck", FIXED_OPTS)
            res = sink(second).sink_cobol(ing, str(root / "ds"))
            assert res.recovery["truncated_commits"] == 1
            got = sink(second).read_dataset(str(root / "ds"))
            assert got.equals(one_shot(first, src, FIXED_OPTS))
            assert got.equals(one_shot(second, src, FIXED_OPTS))
            assert fsck(first, root / "ds")["clean"]


def test_sinkcheck_sigkill_subprocess(tmp_path):
    """The real-SIGKILL harness (`testing.sinkcheck`, on the CPU): a
    consumer subprocess killed once in every commit window plus a parent
    SIGKILL, restarted from the checkpoint, dataset byte-identical."""
    from cobrix_tpu_torch.testing import sinkcheck

    with hard_timeout(300, "sinkcheck"):
        result = sinkcheck.check_kill_matrix(
            "fixed", sinkcheck.make_records(1500),
            {"copybook_contents": sinkcheck.COPYBOOK}, device="cpu",
            work_dir=str(tmp_path))
        assert result["ok"], result
        assert len(result["windows"]) == 4 and result["quarantined"] >= 1


@pytest.mark.slow
def test_sink_kill_fuzz_sweep(tmp_path):
    """Randomized kill-point fuzz across formats and layouts (the slow
    tier of the sink chaos matrix), both packages on each seed."""
    import random

    with hard_timeout(600, "sink fuzz sweep"):
        for seed in range(4):
            rng = random.Random(seed)
            layout = rng.choice(["fixed", "vrl"])
            file_format = rng.choice(["parquet", "arrow"])
            payload = (fixed_records(3000) if layout == "fixed"
                       else rdw_records(3000))
            options = FIXED_OPTS if layout == "fixed" else VRL_OPTS
            points = [rng.choice(faults("port").SINK_KILL_POINTS)
                      for _ in range(rng.randint(1, 3))]
            tables = []
            for pkg in PACKAGES:
                root = tmp_path / f"{pkg}{seed}"
                root.mkdir()
                src = root / "in.dat"
                src.write_bytes(payload)
                drive_with_kills(pkg, src, root / "ck", root / "ds",
                                 root / "faults", options, file_format,
                                 kill_points=tuple(dict.fromkeys(points)))
                got = sink(pkg).read_dataset(str(root / "ds"))
                assert got.equals(one_shot(pkg, src, options)), \
                    f"{pkg} seed {seed} diverged"
                tables.append(got)
            assert tables[1].equals(tables[0])
