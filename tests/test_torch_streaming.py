"""Continuous ingestion and micro-batches on the port
(`cobrix_tpu_torch.streaming`), held to the JAX package.

The port of ``tests/test_streaming_ingest.py`` (less its serve follow
mode and the slow fuzz sweep), of ``TestStreaming`` and
``test_streamer_allows_input_file_name_column`` in
``tests/test_utils_streaming_tools.py``, of
``test_stream_chunks_rejects_file_offsets`` in
``tests/test_review_regressions.py`` and of the ingest drift tests of
``tests/test_stats.py``. Every scenario runs twice on the same feed:
through ``cobrix_tpu`` (``backend="numpy"``) and through
``cobrix_tpu_torch`` (``device="cpu"``), each in a directory of its
own with the same layout. The two runs must give the same batches
(source, generation, byte range, records and table, schema metadata
stripped), the same committed checkpoint payloads (without their
``updated_unix`` and CRC, paths taken relative to the run's directory
and inodes by order of appearance) and the same ``cobrix_stream_*``
counter deltas.

A live feed is made deterministic: `Feed` appends its next torn slice
at the top of each ingest poll (the loop's `_discover`), so both
packages see the file grow between the same polls, and a consumer dies
after a seeded number of batches (abandoning its ingestor, as SIGKILL
would). The subprocess harness `testing.streamcheck` runs the real
SIGKILL shape with a threaded appender.
"""
import itertools
import json
import os
import random

import pytest

pa = pytest.importorskip("pyarrow")

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.obs.metrics import stream_metrics as jax_stream_metrics
from cobrix_tpu_torch.obs.metrics import stream_metrics as port_stream_metrics
from cobrix_tpu_torch.testing import faults as port_faults

from util import hard_timeout

FIXED_COPYBOOK = """
        01  R.
            05  KEY    PIC 9(7) COMP.
            05  NAME   PIC X(9).
"""
FIXED_RS = 13

RDW_COPYBOOK = """
        01  R.
            05  K  PIC X(6).
"""

FIXED_OPTS = {"copybook_contents": FIXED_COPYBOOK}
VRL_OPTS = {"copybook_contents": RDW_COPYBOOK,
            "is_record_sequence": "true",
            "generate_record_id": "true"}

PACKAGES = ("jax", "port")
COUNTERS = ("batches", "records", "rotations", "truncations", "checkpoints")


def fixed_records(n, start=0):
    return b"".join(
        (start + i).to_bytes(4, "big")
        + f"ROW{(start + i) % 1000000:06d}".encode("ascii")
        for i in range(n))


def rdw(payload):
    return bytes([0, 0, len(payload) % 256, len(payload) // 256]) \
        + payload


def rdw_records(n, start=0):
    return b"".join(rdw(f"K{i:05d}".encode("cp037"))
                    for i in range(start, start + n))


def bare(table):
    return table.replace_schema_metadata(None)


def pkg_module(pkg):
    return cobrix_tpu if pkg == "jax" else cobrix_tpu_torch


def pkg_kw(pkg):
    return {} if pkg == "jax" else {"device": "cpu"}


def one_shot(pkg, path, **opts):
    return bare(pkg_module(pkg).read_cobol(str(path), **pkg_kw(pkg),
                                           **opts).to_arrow())


def tail(pkg, path, feed=None, **kw):
    """The package's ingestor over `path` (the port's on the CPU); with
    `feed`, one slice of it is appended at the top of every poll, and
    the stream cannot idle out before the feed is done (so the point
    where it idles does not depend on the machine's speed)."""
    mod = pkg_module(pkg).streaming.ingest
    cls = mod.ContinuousIngestor
    if feed is not None:
        class Stepped(cls):
            @property
            def idle_timeout_s(self):
                return self._idle_after if feed.done else None

            @idle_timeout_s.setter
            def idle_timeout_s(self, value):
                self._idle_after = value

            def _discover(self):
                feed.step()
                super()._discover()
        cls = Stepped
    return cls(str(path), **pkg_kw(pkg), **kw)


def counters(pkg):
    m = (jax_stream_metrics if pkg == "jax" else port_stream_metrics)()
    return {k: m[k].value() for k in COUNTERS}


class Feed:
    """A live file grown by torn slices (`sizes` cycling), one slice a
    `step()`."""

    def __init__(self, path, payload, head, sizes):
        self.path = str(path)
        with open(self.path, "wb") as f:
            f.write(payload[:head])
        self.rest = payload[head:]
        self.sizes = itertools.cycle(sizes)

    def step(self):
        if not self.rest:
            return
        n = next(self.sizes)
        with open(self.path, "ab") as f:
            f.write(self.rest[:n])
        self.rest = self.rest[n:]

    @property
    def done(self):
        return not self.rest


def normalize(payload, root):
    """A checkpoint payload comparable across two run directories:
    without its commit time and CRC, paths relative to `root`, inodes
    by order of appearance."""
    text = json.dumps(payload, sort_keys=True).replace(str(root), "<root>")
    out = json.loads(text)
    out.pop("updated_unix", None)
    out.pop("crc", None)
    inos = {}

    def ino(v):
        return inos.setdefault(str(v), len(inos)) if v else 0
    for src in (out.get("sources") or {}).values():
        src["ino"] = ino(src.get("ino"))
    finished = (out.get("indexers") or {}).get("__finished__")
    if finished:
        out["indexers"]["__finished__"] = {
            str(ino(k)): v for k, v in sorted(finished.items())}
    return out


def latest_payload(ckpt_dir):
    """The newest valid checkpoint slot's payload in `ckpt_dir`."""
    best = None
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.endswith(".ckpt"):
            continue
        try:
            with open(os.path.join(ckpt_dir, name)) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if best is None or payload.get("seq", -1) > best.get("seq", -1):
            best = payload
    return best


class Run:
    """One package's trace of a scenario: batches, committed checkpoint
    payloads after each consumer lifetime, and counter deltas."""

    def __init__(self, pkg, root):
        self.pkg = pkg
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.batches = []
        self.payloads = []
        self._before = counters(pkg)

    def note(self, batch, table=None):
        table = bare(batch.to_arrow()) if table is None else table
        self.batches.append((os.path.relpath(batch.source, self.root),
                             batch.generation, batch.offset_from,
                             batch.offset_to, batch.records, table))
        return table

    def checkpoint(self, ckpt_dir):
        payload = latest_payload(ckpt_dir) if os.path.isdir(ckpt_dir) \
            else None
        self.payloads.append(None if payload is None
                             else normalize(payload, self.root))

    def finish(self):
        after = counters(self.pkg)
        self.deltas = {k: after[k] - self._before[k] for k in COUNTERS}
        return self


def assert_same_runs(jax_run, port_run):
    assert [b[:5] for b in port_run.batches] \
        == [b[:5] for b in jax_run.batches]
    for i, (j, t) in enumerate(zip(jax_run.batches, port_run.batches)):
        assert t[5].equals(j[5]), f"batch {i} ({j[:5]}) differs"
    assert port_run.payloads == jax_run.payloads
    assert port_run.deltas == jax_run.deltas


class ExactlyOnceConsumer:
    """The documented ack protocol, in-process: output truncation to
    the committed app_state on every 'restart'."""

    def __init__(self, run):
        self.run_trace = run
        self.tables = []

    def run(self, make_ingestor, crash_after=None):
        """One consumer lifetime; crash_after = batches before the
        simulated crash (ingestor abandoned, NOTHING acked after the
        last explicit ack — the same recovery surface a SIGKILL
        leaves). Returns True when the feed idled out (finished)."""
        ing = make_ingestor()
        committed = int(ing.app_state or 0)
        del self.tables[committed:]
        n = 0
        finished = True
        for batch in ing.batches():
            self.tables.append(self.run_trace.note(batch))
            batch.ack(app_state=len(self.tables))
            n += 1
            if crash_after is not None and n >= crash_after:
                finished = False
                break  # abandon: no close(), no further acks
        if finished:
            ing.close(finalize=True)
        return finished

    def table(self):
        return pa.concat_tables(self.tables)


# -- the kill/restart matrix -----------------------------------------------


def kill_restart(pkg, root, payload, opts, seed, pipeline, sizes,
                 batch_max_mb, kills=3):
    run = Run(pkg, root)
    src = os.path.join(run.root, "feed.dat")
    ckpt = os.path.join(run.root, "ckpt")
    feed = Feed(src, payload, len(payload) // 3, sizes)
    rng = random.Random(seed)
    consumer = ExactlyOnceConsumer(run)

    def make():
        return tail(pkg, src, feed, checkpoint_dir=ckpt, auto_ack=False,
                    poll_interval_s=0.005, idle_timeout_s=0.05,
                    finalize_on_idle=True, batch_max_mb=batch_max_mb,
                    pipeline_workers=pipeline, **opts)

    cycles = 0
    while True:
        crash = rng.randint(1, 6) if cycles < kills else None
        finished = consumer.run(make, crash_after=crash)
        run.checkpoint(ckpt)
        if finished and feed.done:
            break
        cycles += 1
        assert cycles < 200, "kill/restart loop did not converge"
    assert cycles >= kills
    run.table = consumer.table()
    run.src = src
    return run.finish()


@pytest.mark.parametrize("flavor,pipeline", [
    ("fixed", "0"), ("fixed", "2"), ("vrl", "0"), ("vrl", "2"),
])
def test_kill_restart_matrix_byte_identical(tmp_path, monkeypatch, flavor,
                                           pipeline):
    """Kill/restart at seeded points x fixed/VRL x pipelined catch-up
    on/off: both packages deliver the same batches and commit the same
    checkpoints, and the concatenation is the one-shot read."""
    from cobrix_tpu_torch.engine.pipeline import PipelineExecutor

    drains = []
    real_run = PipelineExecutor.run

    def counted(self, tasks, *a, **k):
        drains.append(len(tasks))
        return real_run(self, tasks, *a, **k)
    monkeypatch.setattr(PipelineExecutor, "run", counted)
    with hard_timeout(300, "kill/restart matrix"):
        payload = (fixed_records(4000) if flavor == "fixed"
                   else rdw_records(4000))
        opts = FIXED_OPTS if flavor == "fixed" else VRL_OPTS
        runs = [kill_restart(pkg, tmp_path / pkg, payload, opts,
                             seed=hash((flavor, pipeline)) & 0xFFFF,
                             pipeline=pipeline,
                             sizes=(7, 3, 29, 2, 111, 9001),
                             batch_max_mb=0.004)
                for pkg in PACKAGES]
        assert_same_runs(*runs)
        # the port's catch-up drain decoded the head's backlog (and the
        # big slices') windows on its pipeline, and only with workers
        assert (min(drains, default=0) > 1) == (pipeline != "0")
        for run in runs:
            assert run.table.equals(one_shot(run.pkg, run.src, **opts))


def test_mid_record_tail_waits_never_garbage(tmp_path):
    """Torn, non-record-aligned appends of 1-9 bytes: no partial record
    is ever decoded; the stream converges to the one-shot read."""
    with hard_timeout(120, "torn appends"):
        payload = rdw_records(150)
        runs = []
        for pkg in PACKAGES:
            run = Run(pkg, tmp_path / pkg)
            src = os.path.join(run.root, "torn.dat")
            feed = Feed(src, payload, 0, (1, 5, 2, 9, 3))
            consumer = ExactlyOnceConsumer(run)
            ckpt = os.path.join(run.root, "ck")
            while not (consumer.run(lambda: tail(
                    pkg, src, feed, checkpoint_dir=ckpt, auto_ack=False,
                    poll_interval_s=0.002, idle_timeout_s=0.05,
                    finalize_on_idle=True, **VRL_OPTS)) and feed.done):
                pass
            run.checkpoint(ckpt)
            assert consumer.table().equals(one_shot(pkg, src, **VRL_OPTS))
            runs.append(run.finish())
        assert_same_runs(*runs)
        # every window ended on a record boundary
        assert all(b[4] >= 1 for b in runs[1].batches)


def test_memory_backend_prefix_tail(tmp_path):
    """Object-store tailing: new immutable objects under a memory://
    prefix are consumed exactly once, equal to the one-shot read, the
    same batches from both packages."""
    fsspec = pytest.importorskip("fsspec")
    with hard_timeout(120, "memory tail"):
        fs = fsspec.filesystem("memory")
        runs = []
        for pkg in PACKAGES:
            prefix = f"/ingest-{pkg}-{os.getpid()}"
            fs.pipe_file(f"{prefix}/a.dat", fixed_records(300))
            run = Run(pkg, f"memory://{prefix}")
            ck = os.path.join(str(tmp_path), pkg, "ck")
            ing = tail(pkg, f"memory://{prefix}/", checkpoint_dir=ck,
                       auto_ack=False, poll_interval_s=0.01,
                       idle_timeout_s=0.2, **FIXED_OPTS)
            it = ing.batches()
            tables = [run.note(next(it))]
            ing.ack(app_state=1)
            fs.pipe_file(f"{prefix}/b.dat", fixed_records(200, 300))
            for batch in it:
                tables.append(run.note(batch))
                batch.ack(app_state=len(tables))
            ing.close()
            run.checkpoint(ck)
            got = pa.concat_tables(tables)
            assert got.equals(one_shot(pkg, f"memory://{prefix}/",
                                       **FIXED_OPTS))
            runs.append(run.finish())
        for run in runs:
            # each package's objects carry their own creation times:
            # the fingerprints are compared for presence only
            run.payloads = [json.loads(json.dumps(p).replace(
                f"-{run.pkg}-", "-")) for p in run.payloads]
            for p in run.payloads:
                for src in p["sources"].values():
                    assert src["remote_fp"]
                    src["remote_fp"] = "fp"
        assert_same_runs(*runs)


# -- checkpoints -------------------------------------------------------------


def _corruption_counter(pkg):
    if pkg == "jax":
        from cobrix_tpu.obs.metrics import default_registry
    else:
        from cobrix_tpu_torch.obs.metrics import default_registry
    return default_registry().counter("cobrix_cache_corruption_total",
                                      label_names=("plane",))


def _corrupt_then_resume(pkg, root, records, crash_after, corrupt):
    run = Run(pkg, root)
    src = os.path.join(run.root, "feed.dat")
    ckpt = os.path.join(run.root, "ckpt")
    with open(src, "wb") as f:
        f.write(fixed_records(records))
    consumer = ExactlyOnceConsumer(run)

    def make():
        return tail(pkg, src, checkpoint_dir=ckpt, auto_ack=False,
                    poll_interval_s=0.005, idle_timeout_s=0.05,
                    finalize_on_idle=True, batch_max_mb=0.002,
                    **FIXED_OPTS)

    consumer.run(make, crash_after=crash_after)
    run.checkpoint(ckpt)
    counter = _corruption_counter(pkg)
    before = counter.value(plane="checkpoint")
    corrupt(ckpt)
    while not consumer.run(make):
        pass
    run.checkpoint(ckpt)
    run.corruptions = counter.value(plane="checkpoint") - before
    run.quarantined = len(os.listdir(os.path.join(ckpt, "quarantine"))) \
        if os.path.isdir(os.path.join(ckpt, "quarantine")) else 0
    assert consumer.table().equals(one_shot(pkg, src, **FIXED_OPTS))
    return run.finish()


def _faults(pkg):
    if pkg == "jax":
        from cobrix_tpu.testing import faults
        return faults
    return port_faults


@pytest.mark.parametrize("mode", ["bitflip", "garbage"])
def test_checkpoint_corruption_self_heals(tmp_path, mode):
    """A corrupted checkpoint slot is quarantined + counted and
    recovery falls back to the other slot — the stream stays exactly
    once through the re-drive, in both packages alike."""
    with hard_timeout(180, "checkpoint corruption"):
        runs = [_corrupt_then_resume(
            pkg, tmp_path / pkg, 900, 4,
            lambda ck, pkg=pkg: _faults(pkg).corrupt_cache_entry(
                ck, "checkpoint", mode)) for pkg in PACKAGES]
        assert_same_runs(*runs)
        for run in runs:
            assert run.corruptions == 1
            assert run.quarantined >= 1


def test_both_slots_corrupt_restarts_from_zero(tmp_path):
    def corrupt_both(ck, pkg):
        for which in (0, 1):
            try:
                _faults(pkg).corrupt_cache_entry(ck, "checkpoint",
                                                 "garbage", which=which)
            except FileNotFoundError:
                break

    with hard_timeout(120, "double corruption"):
        runs = [_corrupt_then_resume(
            pkg, tmp_path / pkg, 400, 3,
            lambda ck, pkg=pkg: corrupt_both(ck, pkg))
            for pkg in PACKAGES]
        assert_same_runs(*runs)


def test_checkpoint_store_two_slot_alternation(tmp_path):
    """Both slots alternate; each package's store loads the other's
    slots (the payload format is shared)."""
    from cobrix_tpu.streaming import CheckpointStore as JaxStore
    from cobrix_tpu.streaming import StreamCheckpoint as JaxCheckpoint
    from cobrix_tpu_torch.streaming import CheckpointStore, StreamCheckpoint

    store = CheckpointStore(str(tmp_path / "ck"))
    for i in range(5):
        store.commit(StreamCheckpoint(delivered_records=i,
                                      app_state={"n": i}))
    loaded = CheckpointStore(str(tmp_path / "ck")).load()
    assert loaded.delivered_records == 4 and loaded.seq == 5
    slots = [p for p in store.slot_paths() if os.path.exists(p)]
    assert len(slots) == 2  # both slots populated, alternating
    assert JaxStore(str(tmp_path / "ck")).load().to_payload() \
        == loaded.to_payload()
    jstore = JaxStore(str(tmp_path / "jck"))
    for i in range(3):
        jstore.commit(JaxCheckpoint(delivered_records=i))
    assert CheckpointStore(str(tmp_path / "jck")).load().to_payload() \
        == JaxStore(str(tmp_path / "jck")).load().to_payload()
    from cobrix_tpu_torch.streaming.checkpoint import (
        checkpoint_files, verify_checkpoint_file)
    assert [verify_checkpoint_file(p)
            for p in checkpoint_files(str(tmp_path / "ck"))] == [None, None]


@pytest.mark.parametrize("first,second", [("jax", "port"),
                                          ("port", "jax")])
def test_checkpoint_resumes_across_packages(tmp_path, first, second):
    """One package consumes part of a live feed with a checkpoint
    directory and stops; the other resumes from that directory. The
    concatenation equals the one-shot read."""
    with hard_timeout(120, "cross-package resume"):
        payload = rdw_records(1200)
        src = tmp_path / "feed.dat"
        ckpt = str(tmp_path / "ck")
        feed = Feed(src, payload, len(payload) // 4, (97, 5, 1311))
        run = Run(first, tmp_path)
        consumer = ExactlyOnceConsumer(run)

        def make(pkg):
            return lambda: tail(
                pkg, src, feed, checkpoint_dir=ckpt, auto_ack=False,
                poll_interval_s=0.005, idle_timeout_s=0.05,
                finalize_on_idle=True, batch_max_mb=0.003, **VRL_OPTS)

        assert not consumer.run(make(first), crash_after=4)
        consumed = len(consumer.tables)
        assert consumed == 4
        while not (consumer.run(make(second)) and feed.done):
            pass
        got = consumer.table()
        for pkg in PACKAGES:
            assert got.equals(one_shot(pkg, src, **VRL_OPTS))


# -- rotation, truncation ------------------------------------------------------


def test_rotation_drains_old_generation_exactly_once(tmp_path):
    """Rename rotation mid-tail: every old-generation record exactly
    once (including bytes appended to the renamed file while the
    handle drains), then the new generation; the same in both
    packages."""
    with hard_timeout(120, "rotation"):
        runs = []
        for pkg in PACKAGES:
            run = Run(pkg, tmp_path / pkg)
            src = os.path.join(run.root, "app.log")
            ck = os.path.join(run.root, "ck")
            with open(src, "wb") as f:
                f.write(fixed_records(50))
            ing = tail(pkg, src, checkpoint_dir=ck,
                       poll_interval_s=0.005, **FIXED_OPTS)
            it = ing.batches()
            first = next(it)
            rotated = _faults(pkg).rotate_source(src,
                                                 fixed_records(30, 1000))
            with open(rotated, "ab") as f:
                f.write(fixed_records(10, 50))
            tables = [run.note(first)]
            rows = first.records
            while rows < 90:
                batch = next(it)
                tables.append(run.note(batch))
                rows += batch.records
            ing.ack()
            ing.close()
            run.checkpoint(ck)
            keys = pa.concat_tables(tables).column("R").to_pylist()
            old = sorted(k["KEY"] for k in keys if k["KEY"] < 1000)
            new = sorted(k["KEY"] for k in keys if k["KEY"] >= 1000)
            assert old == list(range(60))
            assert new == list(range(1000, 1030))
            runs.append(run.finish())
            assert run.deltas["rotations"] == 1
        assert_same_runs(*runs)


def test_truncation_error_policy_is_structured(tmp_path):
    with hard_timeout(60, "truncation error"):
        errors = []
        for pkg in PACKAGES:
            src = tmp_path / f"{pkg}.dat"
            src.write_bytes(fixed_records(80))
            ing = tail(pkg, src, checkpoint_dir=str(tmp_path / pkg),
                       poll_interval_s=0.005, **FIXED_OPTS)
            it = ing.batches()
            next(it)
            _faults(pkg).truncate_source(str(src), 2 * FIXED_RS)
            with pytest.raises(pkg_module(pkg).SourceTruncated) as info:
                next(it)
            assert info.value.path == str(src)
            assert info.value.size < info.value.watermark
            errors.append((info.value.size, info.value.watermark,
                           str(info.value).replace(str(src), "<src>")))
            ing.close()
        assert errors[0] == errors[1]


def test_truncation_restart_policy_reingests(tmp_path):
    with hard_timeout(60, "truncation restart"):
        runs = []
        for pkg in PACKAGES:
            run = Run(pkg, tmp_path / pkg)
            src = os.path.join(run.root, "t.dat")
            with open(src, "wb") as f:
                f.write(fixed_records(60))
            ck = os.path.join(run.root, "ck")
            ing = tail(pkg, src, checkpoint_dir=ck,
                       truncation_policy="restart",
                       poll_interval_s=0.005, idle_timeout_s=0.1,
                       finalize_on_idle=True, **FIXED_OPTS)
            it = ing.batches()
            first = next(it)
            run.note(first)
            assert first.generation == 0
            _faults(pkg).replace_source(src, fixed_records(70, 5000))
            rest = list(it)
            for b in rest:
                run.note(b)
            ing.close()
            run.checkpoint(ck)
            regen = pa.concat_tables([bare(b.to_arrow()) for b in rest])
            keys = [k["KEY"] for k in regen.column("R").to_pylist()]
            assert sorted(keys) == list(range(5000, 5070))
            assert all(b.generation == 1 for b in rest)
            runs.append(run.finish())
            assert run.deltas["truncations"] == 1
        assert_same_runs(*runs)


# -- corruption inside a tailed file -------------------------------------------


def test_permissive_corruption_matches_one_shot(tmp_path):
    """A corrupt RDW run inside a tailed file: the finalized stream's
    ledgered resync behavior equals the one-shot permissive read, and
    each batch's ledger is the JAX package's."""
    with hard_timeout(120, "permissive corruption"):
        good = rdw_records(200)
        corrupted = good[:1100] + b"\x00" * 4 + good[1100:]
        opts = dict(VRL_OPTS, record_error_policy="drop_malformed")
        runs, ledgers = [], []
        for pkg in PACKAGES:
            run = Run(pkg, tmp_path / pkg)
            src = os.path.join(run.root, "c.dat")
            with open(src, "wb") as f:
                f.write(corrupted)
            ck = os.path.join(run.root, "ck")
            ing = tail(pkg, src, checkpoint_dir=ck,
                       poll_interval_s=0.005, idle_timeout_s=0.1,
                       finalize_on_idle=True, batch_max_mb=0.0005,
                       **opts)
            got = []
            for batch in ing:
                got.append(run.note(batch))
                d = batch.diagnostics
                ledgers.append((pkg, d.as_dict() if d is not None
                                else None))
            ing.close()
            run.checkpoint(ck)
            assert pa.concat_tables(got).equals(one_shot(pkg, src, **opts))
            runs.append(run.finish())
        assert_same_runs(*runs)
        norm = [(p, json.loads(json.dumps(d).replace(
            str(tmp_path / p), "<root>"))) for p, d in ledgers]
        assert [d for p, d in norm if p == "jax"] \
            == [d for p, d in norm if p == "port"]


def test_fail_fast_corruption_raises_structured(tmp_path):
    with hard_timeout(60, "fail-fast corruption"):
        good = rdw_records(50)
        messages = []
        for pkg in PACKAGES:
            src = tmp_path / f"{pkg}.dat"
            src.write_bytes(good[:110] + b"\x00" * 4 + good[110:])
            ing = tail(pkg, src, checkpoint_dir=str(tmp_path / pkg),
                       poll_interval_s=0.005, tail_grace_s=0.05,
                       idle_timeout_s=1.0, **VRL_OPTS)
            with pytest.raises(Exception, match="RDW") as info:
                for _ in ing.batches():
                    pass
            messages.append(str(info.value).replace(str(src), "<src>"))
            ing.close()
        assert messages[0] == messages[1]


def test_unsupported_tail_configs_refused():
    for bad in (dict(is_text="true"), dict(variable_size_occurs="true"),
                dict(record_length_field="K"),
                dict(file_start_offset="4"),
                dict(segment_field="K", segment_id_level0="A")):
        errors = []
        for pkg in PACKAGES:
            with pytest.raises(ValueError,
                               match="continuous ingestion") as info:
                pkg_module(pkg).tail_cobol(
                    "/nonexistent", copybook_contents=RDW_COPYBOOK,
                    **pkg_kw(pkg), **bad)
            errors.append(str(info.value))
        assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="truncation_policy"):
        cobrix_tpu_torch.tail_cobol("/nonexistent", device="cpu",
                                    copybook_contents=RDW_COPYBOOK,
                                    truncation_policy="ignore")


def test_entry_points_default_to_the_card(tmp_path):
    """With no device the ingestor and the streamer take the CUDA
    device, and raise where there is none; nothing falls back to the
    CPU."""
    import torch

    from cobrix_tpu_torch.streaming import CobolStreamer, stream_cobol

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "f.dat"
    src.write_bytes(fixed_records(3))
    for make in (lambda: cobrix_tpu_torch.tail_cobol(str(src),
                                                     **FIXED_OPTS),
                 lambda: cobrix_tpu_torch.ContinuousIngestor(
                     str(src), **FIXED_OPTS),
                 lambda: CobolStreamer(FIXED_COPYBOOK),
                 lambda: next(stream_cobol(FIXED_COPYBOOK,
                                           [fixed_records(2)]))):
        with pytest.raises(RuntimeError):
            make()


@pytest.mark.cuda
def test_tail_on_the_card(tmp_path):
    """On a card: a tailed fixed-length and an RDW feed decode there,
    launching the fused kernel (and the scan and pack for RDW), each
    window one pinned upload; tables equal the CPU's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 20 runs "
                    "this path on the card")
    from cobrix_tpu_torch.ops import device_framing as df
    from cobrix_tpu_torch.ops.fused_decode import fused_decode

    for payload, opts in ((fixed_records(3000), FIXED_OPTS),
                          (rdw_records(3000), VRL_OPTS)):
        src = tmp_path / "f.dat"
        src.write_bytes(payload)
        fused_decode.launches = df.scan_window.launches = 0
        ing = cobrix_tpu_torch.tail_cobol(
            str(src), idle_timeout_s=0.05, finalize_on_idle=True,
            batch_max_mb=0.01, **opts)
        got = pa.concat_tables([bare(b.to_arrow()) for b in ing])
        assert got.equals(one_shot("port", src, **opts))
        assert fused_decode.launches > 0
        if opts is VRL_OPTS:
            assert df.scan_window.launches > 0
        report = ing.staging.report()
        assert report["uploads"] == report["pinned_uploads"] > 0


# -- the incremental index -------------------------------------------------------


def test_incremental_index_equals_from_scratch(tmp_path):
    """The port's IncrementalIndexer == the JAX package's
    sparse_index_generator over the same records, survives a state
    round-trip, and the finalized index lands in the port's store where
    a one-shot read finds it."""
    from cobrix_tpu.api import parse_options
    from cobrix_tpu.reader.index import sparse_index_generator
    from cobrix_tpu.reader.stream import MemoryStream
    from cobrix_tpu.reader.var_len_reader import VarLenReader
    from cobrix_tpu_torch.reader.index import IncrementalIndexer

    with hard_timeout(120, "incremental index"):
        data = rdw_records(1000)
        params, _ = parse_options(dict(
            copybook_contents=RDW_COPYBOOK, is_record_sequence="true",
            input_split_records="37"))
        reader = VarLenReader(RDW_COPYBOOK, params)
        want = sparse_index_generator(
            0, MemoryStream(data),
            record_header_parser=reader.record_header_parser(),
            records_per_index_entry=37)
        inc = IncrementalIndexer(records_per_entry=37)
        pos = 0
        mid_state = None
        while pos < len(data):
            length = data[pos + 2] + 256 * data[pos + 3]
            inc.add_record(4 + length, True)
            pos += 4 + length
            if mid_state is None and pos > len(data) // 2:
                mid_state = inc.state_dict()
                inc = IncrementalIndexer.from_state(mid_state)
        assert [(e.offset_from, e.offset_to, e.file_id, e.record_index)
                for e in inc.entries(0)] \
            == [(e.offset_from, e.offset_to, e.file_id, e.record_index)
                for e in want]
        # end to end: tail with cache_dir, finalize, one-shot read hits
        cache = tmp_path / "cache"
        src = tmp_path / "v.dat"
        src.write_bytes(data)
        opts = dict(copybook_contents=RDW_COPYBOOK,
                    is_record_sequence="true", input_split_records="37",
                    cache_dir=str(cache))
        ing = tail("port", src, checkpoint_dir=str(tmp_path / "ck"),
                   poll_interval_s=0.005, idle_timeout_s=0.05,
                   finalize_on_idle=True, batch_max_mb=0.003, **opts)
        tables = [bare(b.to_arrow()) for b in ing]
        warm = cobrix_tpu_torch.read_cobol(str(src), device="cpu", **opts)
        assert warm.metrics.as_dict()["io"].get("index_hits", 0) >= 1
        assert pa.concat_tables(tables).equals(bare(warm.to_arrow()))
        assert pa.concat_tables(tables).equals(one_shot("jax", src, **{
            k: v for k, v in opts.items() if k != "cache_dir"}))


# -- ingest drift (collect_stats=true) ---------------------------------------


def _drift_run(pkg, root, rotate):
    if pkg == "jax":
        from cobrix_tpu.stats import service
    else:
        from cobrix_tpu_torch.stats import service
    service.reset_for_tests()
    run = Run(pkg, root)
    m = (jax_stream_metrics if pkg == "jax" else port_stream_metrics)()
    drift_before = m["stats_drift"].value(kind="out_of_range")
    cache = os.path.join(run.root, "cache")
    src = os.path.join(run.root, "feed.dat")
    ck = os.path.join(run.root, "ck")
    with open(src, "wb") as f:
        f.write(fixed_records(50 if rotate else 80))
    ing = tail(pkg, src, checkpoint_dir=ck, poll_interval_s=0.005,
               collect_stats="true", cache_dir=cache, **FIXED_OPTS)
    it = ing.batches()
    first = next(it)
    run.note(first)
    rows = first.records
    if rotate:
        _faults(pkg).rotate_source(src, fixed_records(50, 1000000))
        while rows < 100:
            batch = next(it)
            run.note(batch)
            rows += batch.records
    for batch in ing.close(finalize=True):
        run.note(batch)
    run.checkpoint(ck)
    run.drift = m["stats_drift"].value(kind="out_of_range") - drift_before
    run.last_drift = m["stats_last_drift"].value()
    run.ring = service.snapshot()["drift"]
    trail = os.path.join(cache, "stats", "drift.jsonl")
    run.trail = []
    if os.path.exists(trail):
        with open(trail) as f:
            run.trail = [{k: v for k, v in json.loads(line).items()
                          if k != "ts"} for line in f]
    return run.finish()


def test_rotation_emits_drift_records(tmp_path):
    """gen0 keys 0..49, gen1 keys 1000000..1000049: the generation
    comparison emits an out_of_range drift record for KEY — to the
    stream metrics, the stats ring and the JSONL trail — the same
    records in both packages."""
    with hard_timeout(120, "ingest drift"):
        runs = [_drift_run(pkg, tmp_path / pkg, rotate=True)
                for pkg in PACKAGES]
        assert_same_runs(*runs)
        jax_run, port_run = runs
        assert port_run.drift == 1 and port_run.last_drift == 1
        assert any(ev["kind"] == "out_of_range" and ev["field"] == "KEY"
                   for ev in port_run.ring), port_run.ring
        def strip(run, events):
            return [json.loads(json.dumps(
                {k: v for k, v in ev.items() if k not in ("ts", "at")}
            ).replace(run.root, "<root>")) for ev in events]
        assert strip(port_run, port_run.ring) \
            == strip(jax_run, jax_run.ring)
        assert port_run.trail and strip(port_run, port_run.trail) \
            == strip(jax_run, jax_run.trail)


def test_unrotated_stream_compares_clean(tmp_path):
    """finalize without rotation = one generation: nothing to compare,
    no drift records, and folding never perturbs delivery."""
    with hard_timeout(60, "single generation"):
        runs = [_drift_run(pkg, tmp_path / pkg, rotate=False)
                for pkg in PACKAGES]
        assert_same_runs(*runs)
        assert runs[1].drift == 0 and not runs[1].trail
        assert runs[1].batches and runs[1].batches[0][4] >= 1


# -- micro-batches ---------------------------------------------------------------


def streamer(pkg, copybook, **opts):
    return pkg_module(pkg).streaming.CobolStreamer(copybook, **pkg_kw(pkg),
                                                   **opts)


def same_batches(jax_batches, port_batches):
    assert len(port_batches) == len(jax_batches)
    for j, t in zip(jax_batches, port_batches):
        assert bare(t.to_arrow()).equals(bare(j.to_arrow()))
        assert t.to_rows() == j.to_rows()
        jd, td = j.diagnostics, t.diagnostics
        assert (td is None) == (jd is None)
        if jd is not None:
            assert td.as_dict() == jd.as_dict()


def test_stream_directory_nondivisible_not_starved(tmp_path):
    """A size-stable non-record-multiple file surfaces through the
    record-error policy instead of pending forever."""
    with hard_timeout(60, "starvation fix"):
        (tmp_path / "bad.dat").write_bytes(fixed_records(5) + b"\x01\x02")
        got = {}
        for pkg in PACKAGES:
            s = streamer(pkg, FIXED_COPYBOOK,
                         record_error_policy="drop_malformed")
            got[pkg] = list(s.stream_directory(
                str(tmp_path), poll_interval=0.05, idle_timeout=1.2))
        same_batches(got["jax"], got["port"])
        (batch,) = got["port"]
        assert len(batch) == 5
        assert batch.diagnostics.corrupt_records >= 1


def test_stream_directory_nondivisible_fail_fast_raises(tmp_path):
    with hard_timeout(60, "starvation fail-fast"):
        (tmp_path / "bad.dat").write_bytes(fixed_records(3) + b"\x01")
        messages = []
        for pkg in PACKAGES:
            s = streamer(pkg, FIXED_COPYBOOK)
            with pytest.raises(ValueError, match="does not divide") as e:
                list(s.stream_directory(str(tmp_path), poll_interval=0.05,
                                        idle_timeout=1.2))
            messages.append(str(e.value))
        assert messages[0] == messages[1]


def test_stream_chunks_carryover_parity():
    """Many tiny unaligned chunks assemble the identical record stream,
    batch for batch with the JAX package."""
    with hard_timeout(60, "chunk carryover"):
        payload = fixed_records(200)
        chunks = [payload[i:i + 41] for i in range(0, len(payload), 41)]
        got = {pkg: list(streamer(pkg, FIXED_COPYBOOK).stream_chunks(
            iter(chunks))) for pkg in PACKAGES}
        same_batches(got["jax"], got["port"])
        rows = [r for b in got["port"] for r in b.to_rows()]
        whole = streamer("port", FIXED_COPYBOOK)._batch(payload).to_rows()
        assert rows == whole
        for pkg in PACKAGES:
            with pytest.raises(ValueError, match="mid-record"):
                list(streamer(pkg, FIXED_COPYBOOK).stream_chunks(
                    [payload[:FIXED_RS + 3]]))


def test_stream_chunks_rejects_file_offsets():
    for pkg in PACKAGES:
        s = streamer(pkg, "       01 R.\n          05 F PIC X(4).\n",
                     file_start_offset="4")
        with pytest.raises(ValueError, match="stream_chunks"):
            list(s.stream_chunks([b"HEADabcd"]))


SIMPLE = """
       01  REC.
           05  ID   PIC 9(3).
           05  NAME PIC X(4).
"""


def _simple_records(n, start=0):
    return b"".join(f"{i:03d}N{i:03d}".encode("ascii")
                    for i in range(start, start + n))


class TestStreaming:
    """``TestStreaming`` of tests/test_utils_streaming_tools.py, each
    case on both packages."""

    def test_stream_chunks_partial_records(self):
        payload = _simple_records(10)
        chunks = [payload[:10], payload[10:11], payload[11:40],
                  payload[40:]]
        got = {pkg: list(pkg_module(pkg).streaming.stream_cobol(
            SIMPLE, chunks, encoding="ascii",
            schema_retention_policy="collapse_root", **pkg_kw(pkg)))
            for pkg in PACKAGES}
        same_batches(got["jax"], got["port"])
        rows = [r for b in got["port"] for r in b.to_rows()]
        assert [r[0] for r in rows] == list(range(10))
        assert len(got["port"]) >= 2

    def test_stream_chunks_trailing_garbage(self):
        for pkg in PACKAGES:
            with pytest.raises(ValueError, match="mid-record"):
                list(streamer(pkg, SIMPLE, encoding="ascii")
                     .stream_chunks([b"\x00" * 3]))

    def test_record_ids_continue_across_batches(self):
        payload = _simple_records(4)
        got = {pkg: list(streamer(
            pkg, SIMPLE, encoding="ascii", generate_record_id="true",
            schema_retention_policy="collapse_root").stream_chunks(
                [payload[:14], payload[14:]])) for pkg in PACKAGES}
        same_batches(got["jax"], got["port"])
        assert [r[1] for b in got["port"] for r in b.to_rows()] \
            == [0, 1, 2, 3]

    def test_stream_directory(self, tmp_path):
        (tmp_path / "a.bin").write_bytes(_simple_records(2))
        (tmp_path / "b.bin").write_bytes(_simple_records(3, start=2))
        got = {pkg: list(streamer(
            pkg, SIMPLE, encoding="ascii",
            schema_retention_policy="collapse_root").stream_directory(
                str(tmp_path), poll_interval=0.01, max_batches=2))
            for pkg in PACKAGES}
        same_batches(got["jax"], got["port"])
        assert [len(b) for b in got["port"]] == [2, 3]
        assert [r[0] for b in got["port"] for r in b.to_rows()] \
            == [0, 1, 2, 3, 4]

    def test_stream_directory_waits_for_missing_path(self, tmp_path):
        s = streamer("port", SIMPLE, encoding="ascii")
        batches = list(s.stream_directory(
            str(tmp_path / "landing"), poll_interval=0.01,
            idle_timeout=0.05))
        assert batches == []  # polls instead of raising

    def test_stream_directory_skips_growing_file(self, tmp_path):
        """A file whose size changes between polls is not consumed until
        stable; a failed decode leaves it unconsumed for retry."""
        import threading
        import time

        p = tmp_path / "grow.bin"
        p.write_bytes(_simple_records(1)[:4])  # partial record
        s = streamer("port", SIMPLE, encoding="ascii",
                     schema_retention_policy="collapse_root")
        gen = s.stream_directory(str(tmp_path), poll_interval=0.01,
                                 max_batches=1, idle_timeout=1.0)

        def finish_write():
            time.sleep(0.05)
            p.write_bytes(_simple_records(3))

        t = threading.Thread(target=finish_write)
        t.start()
        batches = list(gen)
        t.join()
        assert [len(b) for b in batches] == [3]

    def test_rejects_variable_length(self):
        for pkg in PACKAGES:
            with pytest.raises(ValueError, match="fixed-length"):
                streamer(pkg, SIMPLE, is_record_sequence="true")


def test_streamer_allows_input_file_name_column(tmp_path):
    """The streaming relaxation: `with_input_file_name_col` on
    fixed-length records is taken by the streamer and the ingestor
    (read_cobol still refuses it, in both packages)."""
    (tmp_path / "a.bin").write_bytes(_simple_records(3))
    opts = dict(encoding="ascii", with_input_file_name_col="F")
    got = {pkg: list(streamer(pkg, SIMPLE, **opts).stream_directory(
        str(tmp_path), poll_interval=0.01, max_batches=1))
        for pkg in PACKAGES}
    same_batches(got["jax"], got["port"])
    assert got["port"][0].to_dicts()[0]["F"] == str(tmp_path / "a.bin")
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="with_input_file_name_col"):
            pkg_module(pkg).read_cobol(str(tmp_path / "a.bin"),
                                       copybook_contents=SIMPLE,
                                       **pkg_kw(pkg), **opts)
    ing = tail("port", tmp_path / "a.bin", idle_timeout_s=0.05,
               finalize_on_idle=True, poll_interval_s=0.005,
               copybook_contents=SIMPLE, **opts)
    (batch,) = list(ing)
    assert [r["F"] for r in batch.data.to_dicts()] \
        == [str(tmp_path / "a.bin")] * 3


# -- the subprocess harness ----------------------------------------------------


def test_streamcheck_sigkill_subprocess(tmp_path):
    """The real-SIGKILL harness (`testing.streamcheck`, on the CPU):
    consumer subprocesses killed by os._exit AND a parent SIGKILL
    mid-ingest, restarted from the checkpoint, byte-identical output
    whose batches tile the file."""
    from cobrix_tpu_torch.testing import streamcheck

    with hard_timeout(300, "streamcheck"):
        result = streamcheck.check_exactly_once(
            "fixed", streamcheck.make_records(1500),
            {"copybook_contents": streamcheck.COPYBOOK}, kill_cycles=2,
            device="cpu", work_dir=str(tmp_path),
            # windows of about 80 records: every consumer lifetime has
            # the two batches its planned kill waits for, however slowly
            # it starts beside the appender
            ingest={"batch_max_mb": 0.001})
        assert result["ok"], result
        assert result["cycles"] >= 3 and result["parent_killed"]
        src = result["src"]
        assert one_shot("port", src, **{"copybook_contents":
                                        streamcheck.COPYBOOK}).equals(
            one_shot("jax", src, copybook_contents=streamcheck.COPYBOOK))
