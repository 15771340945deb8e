"""The port's one-shot sink (``cobrix_tpu_torch.sink``,
``CobolData.to_dataset``, ``read_dataset``, ``fsck_sink``) on the CPU,
against the JAX package.

The first part is the one-shot half of ``tests/test_sink.py`` run
through the port (``device="cpu"``): export parity in both file
formats, rolling file targets, hive partitioning, schema and config
drift refused, manifest and data-file damage loud for readers, the
unbounded quarantine, full and read-only volumes that never
half-commit, retried staging writes, the sink metrics, the fsck orphan
report, a foreign ``app_state`` and the schema fingerprint's
stability; and a kill in each commit window of a one-shot commit. The
cases that drive ``tail_cobol`` / ``sink_for_ingestor`` wait for the
port's streaming tier.

The second part holds the port to the JAX package (``backend="numpy"``,
one thread): the schema fingerprint of the same file and options, each
package's ``read_dataset`` of the other's dataset (and an append
across them), and ``fsck_sink``'s reports.
"""
import errno
import os

import pytest

pa = pytest.importorskip("pyarrow")

import cobrix_tpu  # noqa: E402
from cobrix_tpu import sink as jsink  # noqa: E402
from cobrix_tpu_torch import read_cobol, read_dataset  # noqa: E402
from cobrix_tpu_torch.io.integrity import corruption_counter  # noqa: E402
from cobrix_tpu_torch.obs.metrics import sink_metrics  # noqa: E402
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow  # noqa: E402
from cobrix_tpu_torch.sink import (  # noqa: E402
    DatasetSink,
    SinkCorruption,
    SinkSchemaError,
    fsck_sink,
    schema_fingerprint,
)
from cobrix_tpu_torch.sink.manifest import MANIFEST_NAME  # noqa: E402
from cobrix_tpu_torch.testing.faults import (  # noqa: E402
    SINK_KILL_POINTS,
    SinkFaultPlan,
    SinkKilled,
    corrupt_sink_manifest,
    sink_write_faults,
)

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

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


def port_read(path, **options):
    return read_cobol(str(path), device="cpu", **options)


def jax_read(path, **options):
    return cobrix_tpu.read_cobol(str(path), backend="numpy",
                                 parallelism="1", **options)


def source(tmp_path, n=500, name="in.dat"):
    src = tmp_path / name
    src.write_bytes(fixed_records(n))
    return src


# -- one-shot export -------------------------------------------------------


@pytest.mark.parametrize("file_format", ["parquet", "arrow"])
def test_one_shot_export_parity(tmp_path, file_format):
    """to_dataset -> read_dataset round-trips byte-identically; a
    second export of the same read appends a second commit."""
    data = port_read(source(tmp_path), **FIXED_OPTS)
    want = bare(data.to_arrow())
    ds = tmp_path / f"ds-{file_format}"
    sink = data.to_dataset(str(ds), file_format=file_format)
    got = read_dataset(str(ds))
    assert got.equals(want)
    assert sink.to_table().equals(want)
    assert sink.last_commit["rows"] == want.num_rows
    assert fsck_sink(str(ds))["clean"]
    data.to_dataset(str(ds), file_format=file_format)
    assert read_dataset(str(ds)).num_rows == 2 * want.num_rows


def test_rolling_file_targets(tmp_path):
    """A large commit rolls into multiple ~target-size files whose
    concatenation is the original table."""
    data = port_read(source(tmp_path, 4000), **FIXED_OPTS)
    ds = tmp_path / "ds"
    sink = data.to_dataset(str(ds), file_format="arrow",
                           target_file_mb=0.01)
    files = os.listdir(ds / "data")
    assert len(files) > 2 and sink.last_commit["files"] == len(files)
    assert read_dataset(str(ds)).equals(bare(data.to_arrow()))


def test_partitioning_hive_layout(tmp_path):
    """partition_by creates hive-style value dirs (nested struct
    fields spell ROOT.FIELD); all rows survive the regrouping."""
    data = port_read(source(tmp_path, 300), **FIXED_OPTS)
    ds = tmp_path / "ds"
    data.to_dataset(str(ds), partition_by=["R.REGION"])
    assert sorted(os.listdir(ds / "data")) == ["REGION=EU", "REGION=US"]
    got = read_dataset(str(ds))
    want = bare(data.to_arrow())
    assert got.num_rows == want.num_rows
    keys = sorted(r["KEY"] for r in got.column("R").to_pylist())
    assert keys == list(range(300))
    with pytest.raises(SinkSchemaError):
        data.to_dataset(str(tmp_path / "ds2"), partition_by=["NOPE"])


def test_partition_by_generated_column(tmp_path):
    """A top-level generated column (Record_Id of an RDW read with
    record ids) partitions too; sorted by record id the rows are the
    read's."""
    src = tmp_path / "in.dat"
    src.write_bytes(rdw_records(40))
    data = port_read(src, **VRL_OPTS)
    ds = tmp_path / "ds"
    data.to_dataset(str(ds), file_format="arrow",
                    partition_by=["File_Id"])
    assert os.listdir(ds / "data") == ["File_Id=0"]
    got = read_dataset(str(ds)).sort_by("Record_Id")
    assert got.equals(bare(data.to_arrow()).sort_by("Record_Id"))


def test_schema_and_config_drift_refused(tmp_path):
    """A dataset written under one copybook fingerprint / format /
    partition spec refuses producers with another."""
    src = source(tmp_path, 50)
    data = port_read(src, **FIXED_OPTS)
    ds = tmp_path / "ds"
    data.to_dataset(str(ds))
    flat = port_read(src, schema_retention_policy="collapse_root",
                     **FIXED_OPTS)
    with pytest.raises(SinkSchemaError):
        flat.to_dataset(str(ds))
    with pytest.raises(SinkSchemaError):
        data.to_dataset(str(ds), file_format="arrow")
    with pytest.raises(SinkSchemaError):
        data.to_dataset(str(ds), partition_by=["R.REGION"])
    # same fingerprint, different sessions: appending is fine
    data.to_dataset(str(ds))
    assert read_dataset(str(ds)).num_rows == 100


def test_empty_read_commits_the_schema(tmp_path):
    """to_dataset of a read with no records commits the schema's empty
    table; it reads back with the schema, in both packages."""
    src = tmp_path / "empty.dat"
    src.write_bytes(b"")
    data = port_read(src, **FIXED_OPTS)
    assert len(data) == 0
    ds = tmp_path / "ds"
    sink = data.to_dataset(str(ds))
    assert sink.last_commit["rows"] == 0
    got = read_dataset(str(ds))
    assert got.num_rows == 0
    assert got.schema.equals(sink.arrow_schema)
    assert got.schema.equals(bare(data.to_arrow()).schema)
    assert jsink.read_dataset(str(ds)).equals(got)
    assert fsck_sink(str(ds))["clean"]


@pytest.mark.parametrize("point", SINK_KILL_POINTS)
def test_one_shot_kill_in_each_window(tmp_path, point):
    """A kill at any commit window of a one-shot commit: before the
    manifest append the dataset reads as it was and the reopen
    quarantines the commit's staged or finalized files; after it the
    commit stands."""
    data = port_read(source(tmp_path, 200), **FIXED_OPTS)
    ds = tmp_path / "ds"
    sink = data.to_dataset(str(ds), target_file_mb=0.001)
    before = read_dataset(str(ds))
    plan = SinkFaultPlan(str(tmp_path / "faults"), action="raise")
    plan.kill(point)
    with plan.installed():
        with pytest.raises(SinkKilled):
            sink.commit_table(bare(data.to_arrow()))
    assert plan.fired(point)
    reopened = DatasetSink(str(ds))
    got = read_dataset(str(ds))
    if point == "post_commit":
        assert got.num_rows == 2 * before.num_rows
    else:
        assert got.equals(before)
        left = (reopened.recovery["quarantined_files"]
                + reopened.recovery["staged_quarantined"])
        assert left > 0 or point == "pre_stage"
    assert fsck_sink(str(ds))["clean"]


# -- manifest and data damage ----------------------------------------------


def test_midfile_manifest_damage_is_loud_for_readers(tmp_path):
    """A bit flip in a manifest record WITH committed records after it
    must raise for readers AND for ADOPT reopens — serving or adopting
    the valid prefix would silently drop the later commits. Terminal
    damage (the crashed-append shape) still reads as the valid
    prefix."""
    data = port_read(source(tmp_path, 200), **FIXED_OPTS)
    ds = tmp_path / "ds"
    sink = data.to_dataset(str(ds))
    sink.commit_table(bare(data.to_arrow()))
    sink.commit_table(bare(data.to_arrow()))
    corrupt_sink_manifest(str(ds), mode="bitflip", which=0)
    before = corruption_counter().value(plane="sink")
    with pytest.raises(SinkCorruption):
        read_dataset(str(ds))
    assert corruption_counter().value(plane="sink") > before
    with pytest.raises(SinkCorruption):
        DatasetSink(str(ds))  # ADOPT reopen must not truncate history
    fsck_sink(str(ds), repair=True)
    assert fsck_sink(str(ds))["clean"]
    # terminal damage on the rebuilt dataset: valid prefix, no raise
    sink2 = DatasetSink(str(ds))
    sink2.commit_table(bare(data.to_arrow()))
    corrupt_sink_manifest(str(ds), mode="torn", which=-1)
    read_dataset(str(ds))


def test_sink_quarantine_is_unbounded(tmp_path):
    """A repair that quarantines MANY committed files must hold every
    one of them (the cache planes' 32-entry quarantine bound would
    turn a repair into silent permanent loss)."""
    data = port_read(source(tmp_path, 3000), **FIXED_OPTS)
    ds = tmp_path / "ds"
    # one commit rolled into dozens of tiny files, plus a second commit
    sink = data.to_dataset(str(ds), file_format="arrow",
                           target_file_mb=0.001)
    sink.commit_table(bare(data.to_arrow()))
    n_files = len(os.listdir(ds / "data"))
    assert n_files > 34
    corrupt_sink_manifest(str(ds), mode="bitflip", which=0)
    fsck_sink(str(ds), repair=True)
    held = os.listdir(ds / "quarantine")
    assert len(held) >= n_files  # every quarantined file survived
    assert fsck_sink(str(ds))["clean"]


def test_reader_detects_data_file_damage(tmp_path):
    """A committed data file whose bytes no longer match the manifest
    CRC reads back as SinkCorruption, never as silently wrong rows."""
    port_read(source(tmp_path, 200), **FIXED_OPTS).to_dataset(
        str(tmp_path / "ds"))
    data_dir = tmp_path / "ds" / "data"
    victim = os.path.join(data_dir, sorted(os.listdir(data_dir))[0])
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0x01
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(SinkCorruption):
        read_dataset(str(tmp_path / "ds"))
    report = fsck_sink(str(tmp_path / "ds"))
    assert report["data_corrupt"] == 1 and not report["clean"]


# -- volume faults ---------------------------------------------------------


def test_enospc_fails_loudly_and_atomically(tmp_path):
    """A full dataset volume: commit_table raises the backend's OWN
    error (ENOSPC), the manifest is unchanged, nothing is acked — and
    the SAME sink commits cleanly once the volume recovers."""
    data = port_read(source(tmp_path, 300), **FIXED_OPTS)
    ds = tmp_path / "ds"
    sink = data.to_dataset(str(ds))
    manifest_before = (ds / MANIFEST_NAME).read_bytes()
    with sink_write_faults("enospc") as faults:
        with pytest.raises(OSError) as info:
            sink.commit_table(bare(data.to_arrow()))
    # exhausted retries re-raise the backend's own error type; the
    # original errno rides the cause chain (io/ retry semantics)
    assert info.value.errno == errno.ENOSPC \
        or info.value.__cause__.errno == errno.ENOSPC
    assert faults.write_attempts >= 1
    assert (ds / MANIFEST_NAME).read_bytes() == manifest_before
    sink.commit_table(bare(data.to_arrow()))
    assert read_dataset(str(ds)).num_rows == 2 * data.to_arrow().num_rows


def test_readonly_manifest_append_never_half_commits(tmp_path):
    """EROFS on the manifest append AFTER data files finalized: the
    commit raises, the manifest holds no torn record, and the next
    open quarantines the finalized-but-unreferenced files."""
    data = port_read(source(tmp_path, 300), **FIXED_OPTS)
    ds = tmp_path / "ds"
    sink = data.to_dataset(str(ds))
    want = read_dataset(str(ds))
    with sink_write_faults("readonly", fail_writes=False) as faults:
        with pytest.raises(OSError) as info:
            sink.commit_table(bare(data.to_arrow()))
    assert info.value.errno == errno.EROFS \
        or info.value.__cause__.errno == errno.EROFS
    assert faults.append_attempts >= 1
    # the failed commit's finalized files are orphans; ADOPT reopen
    # quarantines them and the dataset reads back unchanged
    reopened = DatasetSink(str(ds))
    assert reopened.recovery["quarantined_files"] > 0
    assert read_dataset(str(ds)).equals(want)


def test_staging_write_retries_through_transient_fault(tmp_path):
    """A transient volume error during staging retries under the
    RetryPolicy backoff and the commit succeeds (exhausted retries
    re-raise the backend's own type — proven above)."""
    from cobrix_tpu_torch.sink import writer as writer_mod

    data = port_read(source(tmp_path, 200), **FIXED_OPTS)
    sink = data.to_dataset(str(tmp_path / "ds"))
    original = writer_mod._local_write
    state = {"fails": 2, "attempts": 0}

    def flaky_write(path, payload):
        state["attempts"] += 1
        if state["fails"] > 0:
            state["fails"] -= 1
            raise OSError(errno.EIO, "transient volume blip", path)
        return original(path, payload)

    writer_mod._local_write = flaky_write
    try:
        sink.commit_table(bare(data.to_arrow()))
    finally:
        writer_mod._local_write = original
    assert state["attempts"] >= 3
    assert read_dataset(str(tmp_path / "ds")).num_rows \
        == 2 * data.to_arrow().num_rows


# -- observability + offline tooling --------------------------------------


def test_sink_metrics_in_prometheus(tmp_path):
    from cobrix_tpu_torch import prometheus_text

    m = sink_metrics()
    before = m["batches"].value()
    bytes_before = m["bytes"].value()
    port_read(source(tmp_path, 100), **FIXED_OPTS).to_dataset(
        str(tmp_path / "ds"))
    assert m["batches"].value() == before + 1
    assert m["bytes"].value() > bytes_before
    text = prometheus_text()
    for name in ("cobrix_sink_committed_batches_total",
                 "cobrix_sink_committed_bytes_total",
                 "cobrix_sink_committed_files_total",
                 "cobrix_sink_recovered_commits_total"):
        assert name in text


def _stray_files(ds):
    (ds / "staging").mkdir(exist_ok=True)
    (ds / "staging" / "part-999.parquet").write_bytes(b"x")
    (ds / "data" / "part-stray.parquet").write_bytes(b"y")


def test_fsck_sink_orphan_report(tmp_path):
    """Stray staging/data files (a crashed writer nobody recovered)
    show up in the offline report; --repair quarantines them."""
    port_read(source(tmp_path, 100), **FIXED_OPTS).to_dataset(
        str(tmp_path / "ds"))
    _stray_files(tmp_path / "ds")
    report = fsck_sink(str(tmp_path / "ds"))
    assert report["staging_orphans"] == 1
    assert report["data_orphans"] == 1
    assert not report["clean"]
    repaired = fsck_sink(str(tmp_path / "ds"), repair=True)
    assert repaired["quarantined"] == 2
    assert fsck_sink(str(tmp_path / "ds"))["clean"]


def test_foreign_app_state_starts_from_zero(tmp_path):
    """A manual (unowned) sink reopened with an app_state belonging to
    a DIFFERENT consumer protocol recovers as nothing-committed: the
    dataset truncates and re-drives rather than trusting foreign
    positions."""
    table = bare(port_read(source(tmp_path, 100), **FIXED_OPTS)
                 .to_arrow())
    sink = DatasetSink(str(tmp_path / "ds"),
                       arrow_schema=table.schema,
                       committed_state=None)
    sink.commit_table(table)
    reopened = DatasetSink(str(tmp_path / "ds"),
                           committed_state={"their_protocol": 123})
    assert reopened.recovery["truncated_commits"] == 1
    assert read_dataset(str(tmp_path / "ds")).num_rows == 0


def test_schema_fingerprint_stability(tmp_path):
    """Identically-configured producers fingerprint identically; a
    changed copybook or changed row-shaping option does not."""
    src = source(tmp_path, 20)
    a = port_read(src, **FIXED_OPTS)
    b = port_read(src, **FIXED_OPTS)
    assert a.plan_fingerprint == b.plan_fingerprint
    flat = port_read(src, schema_retention_policy="collapse_root",
                     **FIXED_OPTS)
    schema_a = a.to_arrow().schema
    assert schema_fingerprint(schema_a, a.plan_fingerprint) \
        == schema_fingerprint(b.to_arrow().schema, b.plan_fingerprint)
    assert schema_fingerprint(flat.to_arrow().schema,
                              flat.plan_fingerprint) \
        != schema_fingerprint(schema_a, a.plan_fingerprint)


# -- parity with the JAX package ------------------------------------------


@pytest.mark.parametrize("options", [
    FIXED_OPTS,
    dict(FIXED_OPTS, schema_retention_policy="collapse_root"),
    dict(FIXED_OPTS, ebcdic_code_page="cp037",
         generate_record_id="true"),
    dict(FIXED_OPTS, record_error_policy="permissive",
         corrupt_record_column="_bad"),
])
def test_schema_fingerprint_matches_jax(tmp_path, options):
    """The same file and options give the same dataset identity in
    both packages; the read's diagnostics metadata does not move it."""
    src = source(tmp_path, 30)
    t, j = port_read(src, **options), jax_read(src, **options)
    assert t.plan_fingerprint == j.plan_fingerprint
    t_table, j_table = t.to_arrow(), j.to_arrow()
    assert t_table.equals(j_table)
    fp = schema_fingerprint(t_table.schema, t.plan_fingerprint)
    assert fp == jsink.schema_fingerprint(j_table.schema,
                                          j.plan_fingerprint)
    assert fp == schema_fingerprint(bare(t_table).schema,
                                    t.plan_fingerprint)


@pytest.mark.parametrize("file_format,partition_by", [
    ("parquet", ()), ("arrow", ()), ("parquet", ("R.REGION",))])
def test_datasets_interoperate_with_jax(tmp_path, file_format,
                                        partition_by):
    """Each package writes its own dataset from the same file; each
    package's read_dataset reads the other's equal to its own, and an
    export of one package appends to the other's dataset."""
    src = source(tmp_path, 400)
    t, j = port_read(src, **FIXED_OPTS), jax_read(src, **FIXED_OPTS)
    kw = dict(file_format=file_format, partition_by=list(partition_by),
              target_file_mb=0.005)
    ds_t, ds_j = str(tmp_path / "ds-port"), str(tmp_path / "ds-jax")
    t.to_dataset(ds_t, **kw)
    j.to_dataset(ds_j, **kw)
    mine_t, mine_j = read_dataset(ds_t), jsink.read_dataset(ds_j)
    assert mine_t.equals(mine_j)
    assert read_dataset(ds_j).equals(mine_j)
    assert jsink.read_dataset(ds_t).equals(mine_t)
    assert fsck_sink(ds_j) == jsink.fsck_sink(ds_j)
    assert fsck_sink(ds_t) == jsink.fsck_sink(ds_t)
    # the same identity: a port export appends to the JAX dataset and
    # the JAX export to the port's
    t.to_dataset(ds_j, **kw)
    j.to_dataset(ds_t, **kw)
    assert jsink.read_dataset(ds_j).num_rows == 2 * mine_t.num_rows
    assert read_dataset(ds_t).equals(jsink.read_dataset(ds_t))


def test_fsck_reports_match_jax(tmp_path):
    """fsck_sink of the same damaged datasets gives the same report in
    both packages: orphans, a corrupt data file, a damaged manifest;
    each package's repair leaves a dataset the other calls clean."""
    data = port_read(source(tmp_path, 300), **FIXED_OPTS)
    dirs = {}
    for name in ("orphans", "data", "manifest"):
        for who in ("port", "jax"):
            ds = tmp_path / f"{name}-{who}"
            sink = data.to_dataset(str(ds), file_format="arrow",
                                   target_file_mb=0.002)
            sink.commit_table(bare(data.to_arrow()))
            dirs[name, who] = ds
    for who in ("port", "jax"):
        _stray_files(dirs["orphans", who])
        victim_dir = dirs["data", who] / "data"
        victim = victim_dir / sorted(os.listdir(victim_dir))[1]
        blob = bytearray(victim.read_bytes())
        blob[len(blob) // 3] ^= 0x04
        victim.write_bytes(bytes(blob))
        corrupt_sink_manifest(str(dirs["manifest", who]), mode="bitflip",
                              which=0)
    for name in ("orphans", "data", "manifest"):
        got = fsck_sink(str(dirs[name, "port"]))
        assert got == jsink.fsck_sink(str(dirs[name, "jax"]))
        assert not got["clean"]
        sizes = [os.path.getsize(dirs[name, who] / MANIFEST_NAME)
                 for who in ("port", "jax")]
        repaired = fsck_sink(str(dirs[name, "port"]), repair=True)
        j_repaired = jsink.fsck_sink(str(dirs[name, "jax"]), repair=True)
        # the manifests' lengths differ by their records' timestamps:
        # each repair truncates its own from the damaged record on
        cut = [repaired.pop("truncated_bytes"),
               j_repaired.pop("truncated_bytes")]
        assert repaired == j_repaired
        assert cut == ([0, 0] if name == "orphans" else sizes)
        assert jsink.fsck_sink(str(dirs[name, "port"]))["clean"]
        assert fsck_sink(str(dirs[name, "jax"]))["clean"]
        assert read_dataset(str(dirs[name, "port"])).equals(
            jsink.read_dataset(str(dirs[name, "jax"])))


@pytest.mark.parametrize("file_format", ["parquet", "arrow"])
def test_junk_decimals_export_exactly(tmp_path, file_format):
    """exp1 records with a junk tail whose binary decimals hold more
    digits than their PIC (ROADMAP C5): the port's table is valid Arrow
    (such a value is null), so a Parquet export, which stores a narrow
    decimal in as few bytes as its precision needs, reads back what the
    table holds."""
    import numpy as np

    from cobrix_tpu_torch.testing import generators as gen

    junk = np.random.default_rng(5).integers(0, 256, size=(24, 1493),
                                             dtype=np.uint8)
    src = tmp_path / "e1.dat"
    src.write_bytes(np.concatenate([gen.generate_exp1(40, seed=5), junk])
                    .tobytes())
    data = port_read(src, copybook_contents=gen.EXP1_COPYBOOK)
    table = data.to_arrow()
    table.validate(full=True)
    ds = str(tmp_path / "ds")
    data.to_dataset(ds, file_format=file_format, target_file_mb=0.01)
    got, want = read_dataset(ds), bare(table)
    assert got.schema.equals(want.schema)
    # floats by bit pattern (the junk rows hold NaNs)
    for a, b in zip(got.flatten().flatten().columns,
                    want.flatten().flatten().columns):
        if pa.types.is_floating(a.type):
            a, b = a.combine_chunks(), b.combine_chunks()
            assert a.is_null().equals(b.is_null())
            assert np.array_equal(a.fill_null(0).to_numpy().view(np.uint8),
                                  b.fill_null(0).to_numpy().view(np.uint8))
        else:
            assert a.equals(b)
