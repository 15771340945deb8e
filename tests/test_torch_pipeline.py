"""The pipelined read of the port against the JAX package, on the CPU.

The same generated bytes (numpy seeds, ``cobrix_tpu.testing``) and the
same option dict go to ``cobrix_tpu.read_cobol`` (numpy backend) and to
``cobrix_tpu_torch.read_cobol(..., device="cpu")``, pipelined and
sequential: rows, dicts and Record_Ids must be equal, types included.
Also here: the port's sparse index entry for entry, the executor's
supervision (the JAX package's watchdog cases), the staging pool, the
one-buffer decode, the launch counters under threads, compressed inputs
(raised, not framed), ``file://`` paths, and a seeded sweep of random
copybooks from ``cobrix_tpu.testing.genspec``.
"""
import bz2
import gzip
import lzma
import os
import random
import struct
import sys
import threading
import time
from decimal import Decimal

import numpy as np
import pytest
import torch

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu import native as jax_native
from cobrix_tpu.encode import encode_file
from cobrix_tpu.reader import index as jax_index
from cobrix_tpu.reader import parameters as jax_parameters
from cobrix_tpu.reader import var_len_reader as jax_vlr
from cobrix_tpu.testing import generators as gen
from cobrix_tpu.testing.genspec import CopybookSpec
from cobrix_tpu_torch.api import parse_options
from cobrix_tpu_torch.engine.pipeline import (PipelineExecutor,
                                              PipelineTimeoutError)
from cobrix_tpu_torch.engine.staging import StagingPool
from cobrix_tpu_torch.reader import index as port_index
from cobrix_tpu_torch.reader import parameters as port_parameters
from cobrix_tpu_torch.reader import var_len_reader as port_vlr
from cobrix_tpu_torch.reader.diagnostics import ShardErrorPolicy

from util import hard_timeout

REDEFINES = {"redefine-segment-id-map:0": "STATIC-DETAILS => C",
             "redefine-segment-id-map:1": "CONTACTS => P"}
LEVELS = {"segment_id_level0": "C", "segment_id_level1": "P"}
EXP2 = dict(copybook_contents=gen.EXP2_COPYBOOK, is_record_sequence="true",
            segment_field="SEGMENT-ID", segment_id_prefix="PAR",
            generate_record_id="true", **REDEFINES)
EXP3 = dict(EXP2, copybook_contents=gen.EXP3_COPYBOOK)
EXP1 = dict(copybook_contents=gen.EXP1_COPYBOOK)


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(120, request.node.name):
        yield


def _typed(v):
    """A value tree with each leaf's type; floats by bit pattern, so
    that NaNs compare."""
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_typed(x) for x in v])
    if isinstance(v, float):
        return ("float", struct.pack(">d", v))
    if isinstance(v, Decimal):
        return ("Decimal", repr(v))
    return (type(v).__name__, v)


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _reads(path, options, pipe):
    """(JAX package sequential, port pipelined, port sequential). The
    reference is the JAX package's sequential read on one thread, which
    its own tests hold equal to its pipelined one: the pipelined read
    builds Arrow tables on several worker threads at once, whose first
    pyarrow calls race pyarrow's lazy pandas import and can crash the
    process later (ROADMAP C4); and its threaded shard scan runs the
    native library's OpenMP teams on 16 threads at once, which a loaded
    test machine slows past the test's deadline. Its native calls run
    with a one-thread OpenMP team for the same reason: an all-core team
    a shard, on a machine whose cores other test processes hold, waits
    at every barrier."""
    jax_native.set_thread_omp_width(1)
    try:
        want = cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                     **options)
        want.to_rows()
    finally:
        jax_native.set_thread_omp_width(os.cpu_count() or 1)
    got = cobrix_tpu_torch.read_cobol(path, device="cpu", **options, **pipe)
    seq = cobrix_tpu_torch.read_cobol(path, device="cpu", **options)
    return want, got, seq


def _assert_same(want, got, seq):
    assert got.metrics.pipeline is not None, "pipeline did not engage"
    assert seq.metrics.pipeline is None
    rows = _typed(want.to_rows())
    assert _typed(got.to_rows()) == rows
    assert _typed(seq.to_rows()) == rows
    assert _typed(got.to_dicts()) == _typed(want.to_dicts())


# -- pipelined reads -------------------------------------------------------

@pytest.mark.parametrize("workers", ["1", "4"])
def test_fixed_pipelined_equals_the_jax_package(tmp_path, workers):
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(400, seed=11)
                  .tobytes())
    pipe = dict(pipeline_workers=workers, chunk_size_mb="0.05")
    want, got, seq = _reads(path, EXP1, pipe)
    _assert_same(want, got, seq)
    assert got.metrics.pipeline["chunks"] == got.metrics.shards == 12
    assert len(got.batches) == 12 and len(seq.batches) == 1


def test_fixed_pipelined_torn_tail_raises_as_sequential(tmp_path):
    data = gen.generate_exp1(400, seed=12).tobytes()[:400 * 1493 - 700]
    path = _write(tmp_path, "torn.dat", data)
    with pytest.raises(ValueError) as seq:
        cobrix_tpu_torch.read_cobol(path, device="cpu", **EXP1)
    with pytest.raises(ValueError) as pipe:
        cobrix_tpu_torch.read_cobol(path, device="cpu", pipeline_workers="4",
                                    chunk_size_mb="0.05", **EXP1)
    assert str(pipe.value) == str(seq.value)
    assert "does not divide data size" in str(seq.value)
    with pytest.raises(Exception):
        cobrix_tpu.read_cobol(path, backend="numpy", pipeline_workers="4",
                              chunk_size_mb="0.05", **EXP1).to_rows()


def test_fixed_pipelined_several_files_keep_record_order(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    for i in range(3):
        (d / f"f{i}.dat").write_bytes(
            gen.generate_exp1(120 + i, seed=20 + i).tobytes())
    (d / "f3.dat").write_bytes(b"")
    want, got, seq = _reads(str(d), EXP1, dict(pipeline_workers="3",
                                               chunk_size_mb="0.05"))
    _assert_same(want, got, seq)


@pytest.mark.parametrize("split", ["1", "7", "1000"])
@pytest.mark.parametrize("levels", [False, True], ids=["ids", "levels"])
def test_rdw_shards_equal_the_jax_package(tmp_path, split, levels):
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(700, seed=13))
    options = dict(EXP2, input_split_records=split,
                   **(LEVELS if levels else {}))
    want, got, seq = _reads(path, options, dict(pipeline_workers="3"))
    _assert_same(want, got, seq)
    assert got.metrics.pipeline["chunks"] == got.metrics.shards \
        == len(got.results)
    assert (len(got.results) == 1) == (split == "1000")
    if split == "1" and not levels:
        assert len(got.results) == 699  # every record but the last


@pytest.mark.parametrize("case", ["exp3", "exp2_filter_collapse"])
def test_rdw_shards_other_profiles(tmp_path, case):
    if case == "exp3":
        path = _write(tmp_path, "e3.dat", gen.generate_exp3(30, seed=23))
        options = dict(EXP3, input_split_records="4", **LEVELS)
    else:
        path = _write(tmp_path, "e2.dat", gen.generate_exp2(500, seed=31))
        options = dict(EXP2, input_split_records="37", segment_filter="P",
                       schema_retention_policy="collapse_root")
    want, got, seq = _reads(path, options, dict(pipeline_workers="2"))
    _assert_same(want, got, seq)


def test_rdw_auto_split_by_chunk_size(tmp_path, monkeypatch):
    """A pipelined RDW read with no split option splits by chunk_size_mb
    (the megabyte is shrunk so that a small file splits) and still
    equals an unsplit read."""
    for module in (jax_parameters, jax_vlr, port_parameters, port_vlr):
        monkeypatch.setattr(module, "MEGABYTE", 1000)
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(1500, seed=16))
    want, got, seq = _reads(path, dict(EXP2, **LEVELS),
                            dict(pipeline_workers="3", chunk_size_mb="10"))
    _assert_same(want, got, seq)
    assert got.metrics.shards > 5, "auto-split did not engage"


def test_rdw_two_files_and_windows_inside_shards(tmp_path, monkeypatch):
    """Shards longer than two windows are framed window by window."""
    monkeypatch.setattr(port_vlr, "READ_WINDOW_BYTES", 900)
    d = tmp_path / "two"
    d.mkdir()
    for k in range(2):
        (d / f"part{k}.dat").write_bytes(gen.generate_exp2(300 + 50 * k,
                                                           seed=40 + k))
    want, got, seq = _reads(str(d), dict(EXP2, **LEVELS,
                                         input_split_records="150"),
                            dict(pipeline_workers="2"))
    _assert_same(want, got, seq)


@pytest.mark.parametrize("options", [
    dict(LEVELS, input_split_records="100"),
    dict(input_split_records="100"),
    dict(input_split_size_mb="1")], ids=["root_aligned", "any_record",
                                         "by_size"])
def test_record_ids_after_a_file_header(tmp_path, monkeypatch, options):
    """A file header counts as one record from the first split on: the
    pipelined read gets that from its shards, the sequential read from
    its shift, and both equal the JAX package."""
    for module in (jax_parameters, jax_vlr, port_parameters, port_vlr):
        monkeypatch.setattr(module, "MEGABYTE", 2000)
    path = _write(tmp_path, "hdr.dat", b"\x07" * 20
                  + gen.generate_exp2(600, seed=41) + b"\x00" * 13)
    opts = dict(EXP2, file_start_offset="20", file_end_offset="13",
                **options)
    want, got, seq = _reads(path, opts, dict(pipeline_workers="2"))
    _assert_same(want, got, seq)
    ids = [r[1] for r in seq.to_rows()]
    assert ids[0] == 0 and ids[-1] - ids[0] == len(ids)  # one +1 step


@pytest.mark.parametrize("options", [
    dict(input_split_records="1"), dict(input_split_records="9"),
    dict(LEVELS, input_split_records="9"), dict(input_split_size_mb="1"),
    dict(LEVELS, file_start_offset="20", file_end_offset="13",
         input_split_records="50"),
    dict(file_start_offset="20", file_end_offset="13",
         input_split_size_mb="2"),
    dict(input_split_records="1000")],
    ids=["records1", "records9", "roots9", "size", "header_footer_roots",
         "header_size", "one_entry"])
def test_sparse_index_equals_the_jax_package(tmp_path, monkeypatch,
                                             options):
    for module in (jax_parameters, jax_vlr, port_parameters, port_vlr):
        monkeypatch.setattr(module, "MEGABYTE", 1000)
    data = gen.generate_exp2(400, seed=43)
    if "file_start_offset" in options:
        data = b"\x07" * 20 + data + b"\x00" * 13
    path = _write(tmp_path, "idx.dat", data)
    opts = dict(EXP2, **options)
    del opts["copybook_contents"]
    jparams, _ = cobrix_tpu.api.parse_options(opts)
    jreader = jax_vlr.VarLenReader(gen.EXP2_COPYBOOK, jparams)
    want = jax_index.file_index_entries(jreader, path, 3, jparams)
    pparams = parse_options(opts)
    preader = port_vlr.VarLenReader(gen.EXP2_COPYBOOK, pparams, device="cpu")
    got = port_index.file_index_entries(preader, path, 3, pparams)
    assert len(want) > 1 or options == {"input_split_records": "1000"}
    assert [tuple(vars(e).values()) for e in got] == \
        [tuple(vars(e).values()) for e in want]


def test_small_files_need_no_index(tmp_path):
    path = _write(tmp_path, "small.dat", gen.generate_exp2(50, seed=44))
    params = parse_options({"is_record_sequence": "true"})
    reader = port_vlr.VarLenReader(gen.EXP2_COPYBOOK, params, device="cpu")
    assert port_index.file_index_entries(reader, path, 0, params) is None


def test_enable_indexes_false_reads_one_shard(tmp_path):
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(300, seed=45))
    opts = dict(EXP2, input_split_records="10", enable_indexes="false")
    want, got, seq = _reads(path, opts, dict(pipeline_workers="2"))
    _assert_same(want, got, seq)
    assert got.metrics.shards == 1


@pytest.mark.parametrize("option,value,message", [
    ("chunk_size_mb", "0", "Invalid 'chunk_size_mb'"),
    ("max_inflight_chunks", "-1", "Invalid 'max_inflight_chunks'"),
    ("shard_timeout_s", "-2", "Invalid 'shard_timeout_s'"),
    ("scan_deadline_s", "-1", "Invalid 'scan_deadline_s'"),
    ("shard_max_retries", "-1", "Invalid 'shard_max_retries'"),
    ("shard_error_policy", "sometimes", "shard_error_policy"),
    ("compression", "lz4", "Invalid 'compression' option"),
    ("input_split_records", "0", "Invalid input split size"),
    ("input_split_size_mb", "3000", "Invalid input split size")])
def test_option_errors_match_the_jax_package(tmp_path, option, value,
                                             message):
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(20, seed=46))
    opts = dict(EXP2, **{option: value})
    with pytest.raises(ValueError) as want:
        cobrix_tpu.read_cobol(path, backend="numpy", **opts).to_rows()
    with pytest.raises(ValueError) as got:
        cobrix_tpu_torch.read_cobol(path, device="cpu", **opts)
    assert message in str(want.value)
    # the codec list differs: the port registers no zlib or zstd
    assert str(got.value).split("; one of")[0] == \
        str(want.value).split("; one of")[0]


def test_split_options_are_rdw_options(tmp_path):
    """The split options shard variable-length reads only: a plain
    fixed-length file reads whole, as in the JAX package, which takes
    them on every read."""
    path = _write(tmp_path, "e1.dat", gen.generate_exp1(3, seed=1).tobytes())
    got = cobrix_tpu_torch.read_cobol(path, device="cpu",
                                      input_split_records="2", **EXP1)
    want = cobrix_tpu.read_cobol(path, backend="numpy",
                                 input_split_records="2", **EXP1)
    assert got.metrics.shards == 1 and len(got.batches) == 1
    assert _typed(got.to_rows()) == _typed(want.to_rows())


@pytest.mark.parametrize("workers", [0, 3, -1, -5])
def test_pipeline_workers_resolve_as_the_jax_package(workers):
    jparams, _ = cobrix_tpu.api.parse_options(
        {"pipeline_workers": str(workers)})
    pparams = parse_options({"pipeline_workers": str(workers)})
    assert pparams.resolved_pipeline_workers() == \
        jparams.resolved_pipeline_workers()
    assert pparams.resolved_pipeline_workers() == (
        workers if workers >= 0 else min(8, os.cpu_count() or 1))


def test_metrics_of_a_sequential_read(tmp_path):
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(30, seed=47))
    data = cobrix_tpu_torch.read_cobol(path, device="cpu", **EXP2)
    m = data.metrics.as_dict()
    assert (m["files"], m["shards"], m["records"], m["bytes_read"]) == \
        (1, 1, 30, os.path.getsize(path))
    assert m["pipeline"] is None and m["stage_busy"] is None


def test_a_failing_shard_under_the_partial_policy(tmp_path, monkeypatch):
    """A shard whose decode raises twice is ledgered, and the others'
    rows come back in order."""
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(200, seed=48))
    real = port_vlr.VarLenReader.read_shard

    def flaky(self, staged, file_id, offset_from, record_index, *a, **k):
        if record_index == 100:
            raise RuntimeError("poison shard")
        return real(self, staged, file_id, offset_from, record_index,
                    *a, **k)

    monkeypatch.setattr(port_vlr.VarLenReader, "read_shard", flaky)
    opts = dict(EXP2, input_split_records="50")
    got = cobrix_tpu_torch.read_cobol(path, device="cpu",
                                      pipeline_workers="2",
                                      shard_error_policy="partial", **opts)
    monkeypatch.setattr(port_vlr.VarLenReader, "read_shard", real)
    full = cobrix_tpu_torch.read_cobol(path, device="cpu", **opts).to_rows()
    assert [f.reason for f in got.shard_failures] == ["error"]
    assert got.shard_failures[0].record_index == 100
    assert got.shard_failures[0].attempts == 2
    assert got.to_rows() == full[:100] + full[150:]
    assert got.metrics.supervision["chunk_retries"] == 1
    with pytest.raises(RuntimeError, match="poison shard"):
        monkeypatch.setattr(port_vlr.VarLenReader, "read_shard", flaky)
        cobrix_tpu_torch.read_cobol(path, device="cpu", pipeline_workers="2",
                                    **opts)


@pytest.mark.parametrize("workers", ["0", "2"])
def test_malformed_header_raises_the_jax_packages_error(tmp_path, workers):
    """A zeroed RDW header inside a file split in shards: the pipelined
    read raises the same FramingError as the JAX package's (from the
    index pass, at its file offset)."""
    from cobrix_tpu.reader.diagnostics import FramingError as JaxError
    from cobrix_tpu_torch.reader.diagnostics import FramingError

    data = bytearray(gen.generate_exp2(300, seed=51))
    pos, k = 0, 0
    while k < 137:
        pos += 4 + (data[pos + 2] | data[pos + 3] << 8)
        k += 1
    data[pos:pos + 4] = b"\x00\x00\x00\x00"
    path = _write(tmp_path, "bad.dat", bytes(data))
    opts = dict(EXP2, input_split_records="40", pipeline_workers=workers)
    with pytest.raises(JaxError) as want:
        cobrix_tpu.read_cobol(path, backend="numpy", **opts).to_rows()
    with pytest.raises(FramingError) as got:
        cobrix_tpu_torch.read_cobol(path, device="cpu", **opts)
    w, g = want.value, got.value
    assert (str(g), g.offset, g.reason, g.header) == \
        (str(w), w.offset, w.reason, w.header)
    assert g.offset == pos


# -- the executor's supervision (tests/test_supervision.py's cases) -------

def _task(i, proc):
    return ((lambda: i), proc)


def test_pipeline_requeues_chunk_once():
    failed_once = []

    def proc(x):
        if x == 1 and not failed_once:
            failed_once.append(x)
            raise RuntimeError("transient chunk failure")
        return x * 10

    ex = PipelineExecutor(2)
    assert ex.run([_task(i, proc) for i in range(4)]) == [0, 10, 20, 30]
    assert ex.report["chunk_retries"] == 1


def test_pipeline_second_failure_is_fatal_fail_fast():
    def proc(x):
        if x == 1:
            raise RuntimeError("poison chunk")
        return x

    ex = PipelineExecutor(2)
    with pytest.raises(RuntimeError, match="poison chunk"):
        ex.run([_task(i, proc) for i in range(3)])
    assert ex.report["chunk_retries"] == 1


def test_pipeline_partial_drops_failed_chunk_with_ledger():
    def proc(x):
        if x == 0:
            raise ValueError("poison chunk 0")
        return x

    ex = PipelineExecutor(2, error_policy=ShardErrorPolicy.PARTIAL)
    out = ex.run([_task(i, proc) for i in range(3)])
    assert out == [None, 1, 2]
    assert [f.reason for f in ex.shard_failures] == ["error"]
    assert "poison chunk 0" in ex.shard_failures[0].error


def test_pipeline_chunk_deadline_fail_fast_names_stage():
    def proc(x):
        if x == 1:
            time.sleep(30)
        return x

    ex = PipelineExecutor(2, chunk_timeout_s=1.0)
    t0 = time.monotonic()
    with pytest.raises(PipelineTimeoutError, match="decode"):
        ex.run([_task(i, proc) for i in range(3)])
    assert time.monotonic() - t0 < 15  # bounded: no indefinite join


def test_pipeline_chunk_deadline_partial_respawns_worker():
    def proc(x):
        if x == 1:
            time.sleep(30)
        return x

    ex = PipelineExecutor(2, chunk_timeout_s=1.0,
                          error_policy=ShardErrorPolicy.PARTIAL)
    out = ex.run([_task(i, proc) for i in range(5)])
    assert out == [0, None, 2, 3, 4]
    assert ex.report["chunk_timeouts"] == 1
    assert ex.report["respawned_workers"] >= 1
    assert [f.reason for f in ex.shard_failures] == ["timeout"]


def test_pipeline_scan_deadline_bounded():
    def proc(x):
        time.sleep(30)
        return x

    ex = PipelineExecutor(2, scan_deadline_s=1.0)
    t0 = time.monotonic()
    with pytest.raises(PipelineTimeoutError, match="scan deadline"):
        ex.run([_task(i, proc) for i in range(2)])
    assert time.monotonic() - t0 < 15


def test_pipeline_stall_reports_stuck_stage():
    """A wedged assembler (no deadlines configured) trips the stall
    backstop and the error names the stuck stage instead of hanging."""
    def proc(x):
        return x

    def finalize(result):
        time.sleep(60)

    ex = PipelineExecutor(1, stall_timeout_s=1.5)
    with pytest.raises(PipelineTimeoutError, match="assemble"):
        ex.run([((lambda: 0), proc, finalize)])


def test_pipeline_report_and_order_under_load():
    """Results in chunk order whatever the completion order; the report
    carries the shape the reads print."""
    rng = random.Random(3)
    delays = [rng.random() * 0.01 for _ in range(40)]

    def proc(x):
        time.sleep(delays[x])
        return x

    ex = PipelineExecutor(6, max_inflight=3)
    assert ex.run([_task(i, proc) for i in range(40)]) == list(range(40))
    r = ex.report
    assert (r["chunks"], r["workers"], r["max_inflight"]) == (40, 6, 3)
    assert 1 <= r["peak_queue"] <= 3
    assert r["overlap"] == round(r["busy_s"] / r["wall_s"], 3)


# -- staging, the one-buffer decode, launch counters ----------------------

def test_staging_pool_reuses_bounded_buffers():
    pool = StagingPool(2, torch.device("cpu"))
    a, b = pool.acquire(100), pool.acquire(50)
    assert not pool.pin and a.host().numel() == 100
    got = []
    t = threading.Thread(target=lambda: got.append(pool.acquire(80)))
    t.start()
    t.join(0.3)
    assert t.is_alive() and not got  # both buffers are out: it waits
    a.host().fill_(7)
    chunk = a.to_device(torch.device("cpu"))
    a.close()
    a.close()  # idempotent
    t.join(5)
    assert not t.is_alive() and got[0].nbytes == 80
    assert int(chunk.sum()) == 700  # a clone, not the reused buffer
    b.close()
    c = pool.acquire(200)  # larger than every free buffer: replaces one
    assert c.host().numel() == 200
    r = pool.report()
    assert (r["acquires"], r["allocations"], r["buffers"]) == (4, 3, 2)
    fresh = pool.fresh(10)
    fresh.close()
    assert pool.report()["allocations"] == 4
    with pytest.raises(RuntimeError, match="after close"):
        fresh.host()


def test_one_host_buffer_per_decoded_batch(tmp_path):
    """Every host plane of a batch (fused planes, strings, floats) is a
    view of one buffer; so are a packed batch's short rows."""
    path = _write(tmp_path, "e3.dat", gen.generate_exp3(12, seed=49))
    data = cobrix_tpu_torch.read_cobol(path, device="cpu", **EXP3)
    for seg in data.results[0].segments:
        batch = seg.batch
        bases = set()
        for col in range(len(batch.decoder.plan.columns)):
            for arr in batch.column_arrays(col).values():
                if isinstance(arr, np.ndarray):
                    base = arr
                    while base.base is not None and isinstance(
                            base.base, np.ndarray):
                        base = base.base
                    bases.add(id(base))
        for row in batch.host_rows.values():
            base = row
            while base.base is not None and isinstance(base.base,
                                                       np.ndarray):
                base = base.base
            bases.add(id(base))
        assert len(bases) == 1


def test_launch_counters_lose_nothing_under_threads():
    from cobrix_tpu_torch.ops._build import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch(wrapper) for _ in range(5000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 5000


@pytest.mark.cuda
def test_pipelined_read_on_the_card(tmp_path):
    """On a card: each worker on its own stream, pinned staging, and the
    rows of a pipelined read equal the sequential read's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this path on "
                    "the card")
    path = _write(tmp_path, "e2.dat", gen.generate_exp2(3000, seed=50))
    opts = dict(EXP2, **LEVELS, input_split_records="200")
    got = cobrix_tpu_torch.read_cobol(path, pipeline_workers="4", **opts)
    seq = cobrix_tpu_torch.read_cobol(path, **opts)
    assert got.metrics.pipeline["staging"]["pinned"]
    assert _typed(got.to_rows()) == _typed(seq.to_rows())


# -- compressed inputs and file:// paths (ROADMAP C1, C2) -----------------

C1_COPYBOOK = """
       01  REC.
           05  A  PIC X(4).
           05  B  PIC S9(5) COMP-3.
"""


def _c1_bytes(framing, n=40):
    bodies = [[("AB%02d" % i, i * 7 - 50)] for i in range(n)]
    return encode_file(C1_COPYBOOK, bodies, framing=framing)


@pytest.mark.parametrize("framing", ["rdw", "fixed"])
def test_compressed_input_raises_and_names_it(tmp_path, framing):
    """A gzip feed, which the port once refused by name, now reads as its
    decompressed bytes: the rows of the JAX package's read of the feed
    and of the port's read of the raw file, sequential and pipelined."""
    raw = _c1_bytes(framing)
    path = _write(tmp_path, "feed.dat", gzip.compress(raw))
    plain = _write(tmp_path, "plain.dat", raw)
    opts = ({"is_record_sequence": "true"} if framing == "rdw" else {})
    want = cobrix_tpu.read_cobol(path, copybook_contents=C1_COPYBOOK,
                                 backend="numpy", **opts).to_rows()
    assert len(want) == 40 and want[0] == [("AB00", -50)]
    for extra in ({}, {"pipeline_workers": "2"}):
        got = cobrix_tpu_torch.read_cobol(path, copybook_contents=C1_COPYBOOK,
                                          device="cpu", **opts, **extra)
        assert _typed(got.to_rows()) == _typed(want)
        # without a cache_dir the sizing pass and the read each inflate
        assert got.metrics.as_dict()["io"]["decompressed_bytes_out"] == \
            2 * len(raw)
    same = cobrix_tpu_torch.read_cobol(plain, copybook_contents=C1_COPYBOOK,
                                       device="cpu", **opts).to_rows()
    assert _typed(same) == _typed(want)


def test_compression_none_reads_the_raw_bytes(tmp_path):
    path = _write(tmp_path, "feed.dat", gzip.compress(_c1_bytes("rdw")))
    opts = {"is_record_sequence": "true", "compression": "none"}
    want = cobrix_tpu.read_cobol(path, copybook_contents=C1_COPYBOOK,
                                 backend="numpy", **opts).to_rows()
    got = cobrix_tpu_torch.read_cobol(path, copybook_contents=C1_COPYBOOK,
                                      device="cpu", **opts).to_rows()
    assert _typed(got) == _typed(want)


@pytest.mark.parametrize("codec,compress,name", [
    ("bz2", bz2.compress, "feed.dat"), ("xz", lzma.compress, "feed.dat"),
    ("gzip", gzip.compress, "feed.bin.gz")])
def test_every_sniffed_codec_raises(tmp_path, codec, compress, name):
    """Every sniffed codec, once refused, inflates to the JAX package's
    rows; the read counts the compressed bytes it fed the inflater."""
    wire = compress(_c1_bytes("fixed"))
    path = _write(tmp_path, name, wire)
    want = cobrix_tpu.read_cobol(path, copybook_contents=C1_COPYBOOK,
                                 backend="numpy").to_rows()
    got = cobrix_tpu_torch.read_cobol(path, copybook_contents=C1_COPYBOOK,
                                      device="cpu")
    assert len(want) == 40 and _typed(got.to_rows()) == _typed(want)
    # the sizing pass and the read each inflate the feed once
    assert got.metrics.as_dict()["io"]["compressed_bytes_in"] == \
        2 * len(wire)


def test_a_raw_file_named_gz_reads_raw_and_a_pin_raises(tmp_path):
    """A raw file named .gz reads raw (the magic vetoes the name); pinned
    as gzip, its bytes are damage, and the read raises the JAX package's
    CompressedStreamError at the same offsets."""
    from cobrix_tpu.io.compress import CompressedStreamError as JaxDamage
    from cobrix_tpu_torch.io.compress import CompressedStreamError

    path = _write(tmp_path, "raw.gz", _c1_bytes("fixed", 5))
    kw = dict(copybook_contents=C1_COPYBOOK)
    want = cobrix_tpu.read_cobol(path, backend="numpy", **kw).to_rows()
    got = cobrix_tpu_torch.read_cobol(path, device="cpu", **kw).to_rows()
    assert _typed(got) == _typed(want) and len(got) == 5
    with pytest.raises(JaxDamage) as jerr:
        cobrix_tpu.read_cobol(path, backend="numpy", compression="gz", **kw)
    with pytest.raises(CompressedStreamError) as perr:
        cobrix_tpu_torch.read_cobol(path, device="cpu", compression="gz",
                                    **kw)
    w, g = jerr.value, perr.value
    assert (str(g), g.codec, g.compressed_offset, g.decompressed_offset) \
        == (str(w), w.codec, w.compressed_offset, w.decompressed_offset)


def test_file_url_reads_the_local_file(tmp_path):
    path = _write(tmp_path, "five.dat", _c1_bytes("fixed", 5))
    url = "file://" + path
    want = cobrix_tpu.read_cobol(url, copybook_contents=C1_COPYBOOK,
                                 backend="numpy").to_rows()
    got = cobrix_tpu_torch.read_cobol(url, copybook_contents=C1_COPYBOOK,
                                      device="cpu").to_rows()
    assert len(want) == 5 and _typed(got) == _typed(want)
    # an s3:// path resolves as the JAX package resolves it (fsspec's s3
    # protocol, or no backend at all) and fails with the JAX package's
    # own error type and message
    with pytest.raises(Exception) as jerr:
        cobrix_tpu.read_cobol("s3://bucket/five.dat",
                              copybook_contents=C1_COPYBOOK, backend="numpy")
    with pytest.raises(Exception) as perr:
        cobrix_tpu_torch.read_cobol("s3://bucket/five.dat",
                                    copybook_contents=C1_COPYBOOK,
                                    device="cpu")
    assert type(perr.value) is type(jerr.value)
    assert str(perr.value) == str(jerr.value).replace(
        "cobrix_tpu.", "cobrix_tpu_torch.")


# -- random copybooks (testing/genspec.py) --------------------------------

GENSPEC_PAGES = ("common", "cp037", "cp500", "cp1047")


def _genspec_case(seed, case):
    rng = random.Random(7000 + seed)
    spec = CopybookSpec.random(rng, allow_depending=False,
                               code_page=GENSPEC_PAGES[seed % 4])
    bodies = [spec.random_body(rng) for _ in range(12)]
    framing = "rdw" if case == "rdw" else "fixed"
    data = encode_file(spec.copybook_text, bodies,
                       **spec.encode_options(framing))
    options = spec.read_options(framing)
    if case == "noisy":
        nrng = np.random.default_rng(seed)
        raw = np.frombuffer(data, dtype=np.uint8).copy()
        at = np.arange(nrng.integers(0, 7), raw.size, 7)
        raw[at] = nrng.integers(0, 256, at.size, dtype=np.uint8)
        data = raw.tobytes()
        options["string_trimming_policy"] = rng.choice(
            ["none", "left", "right", "both"])
        options["schema_retention_policy"] = rng.choice(
            ["keep_original", "collapse_root"])
        options["floating_point_format"] = rng.choice(
            ["ibm", "ieee754", "ibm_little_endian", "ieee754_little_endian"])
    return data, options


@pytest.mark.parametrize("case", ["fixed", "noisy", "rdw"])
@pytest.mark.parametrize("seed", range(8))
def test_genspec_copybooks_equal_the_jax_package(tmp_path, seed, case):
    data, options = _genspec_case(seed, case)
    path = _write(tmp_path, "gen.dat", data)
    want = cobrix_tpu.read_cobol(path, backend="numpy", **options)
    got = cobrix_tpu_torch.read_cobol(path, device="cpu", **options)
    assert len(got) == len(want) == 12
    assert got.schema.field_names() == want.schema.field_names()
    assert _typed(got.to_rows()) == _typed(want.to_rows())
