"""The port's storage backends, retries, block cache, read-ahead and
persisted sparse index against the JAX package's.

Mirrors tests/test_remote_io.py and tests/test_stream_backends.py on the
CPU. The matrix: fsspec ``memory://`` (where fsspec imports) and a
registered ``local://`` backend x fixed/RDW framing x sequential/
pipelined reads x network-shaped faults (``ChaosSource``). A remote read
must give the table of the port's local read of the same bytes and the
JAX package's read of the same URL; a warm re-read of an unchanged file
fetches no backend bytes and makes no index pass on the card; a changed
file invalidates both planes; retries land on the read's ledger.
"""
import json
import os
import struct
import subprocess
import sys
import uuid

import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.testing.faults import (register_chaos_backend as
                                       jax_register_chaos_backend)
from cobrix_tpu_torch import register_stream_backend
from cobrix_tpu_torch.io.blockcache import CachingSource, shared_block_cache
from cobrix_tpu_torch.reader import var_len_reader as port_vlr
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.reader.stream import (BufferedSourceStream,
                                            ByteRangeSource, SourceFile,
                                            _LocalFileSource, open_stream,
                                            path_scheme)
from cobrix_tpu_torch.testing import generators as pgen
from cobrix_tpu_torch.testing.faults import register_chaos_backend

from util import hard_timeout

warm_pyarrow()

FIXED_COPYBOOK = """
       01  RECORD.
           05  ID        PIC 9(4).
           05  NAME      PIC X(8).
"""
FIXED_RECORD_BYTES = 12

VRL_COPYBOOK = """
       01  RECORD.
           05  ID        PIC 9(4).
           05  PAYLOAD   PIC X(40).
"""
VRL_OPTS = dict(is_record_sequence="true", is_rdw_big_endian="true")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(240, request.node.name):
        yield


def fixed_payload(n: int) -> bytes:
    return b"".join(
        f"{i % 10000:04d}{'N%03d' % (i % 1000):<8}".encode("cp037")
        for i in range(n))


def vrl_payload(n: int) -> bytes:
    out = []
    for i in range(n):
        body = f"{i:04d}{'P%02d' % (i % 90):<40}".encode("cp037")
        out.append(struct.pack(">HH", len(body), 0) + body)
    return b"".join(out)


def _port(path, **opts):
    return cobrix_tpu_torch.read_cobol(path, device="cpu", **opts)


def _jax(path, **opts):
    return cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                 **opts)


def _table_eq(a, b):
    assert a.num_rows == b.num_rows
    assert a.column_names == b.column_names
    for name in a.column_names:
        if "File_Name" in name:
            continue
        assert a.column(name).equals(b.column(name)), name


def io_counters(data) -> dict:
    return data.metrics.as_dict().get("io") or {}


def _fmt(fmt: str, n: int):
    if fmt == "fixed":
        return fixed_payload(n), dict(copybook_contents=FIXED_COPYBOOK)
    return vrl_payload(n), dict(copybook_contents=VRL_COPYBOOK, **VRL_OPTS)


def _mem_write(data: bytes, name: str = "data.dat") -> str:
    fsspec = pytest.importorskip("fsspec")
    bucket = f"/t{uuid.uuid4().hex[:12]}"
    fs = fsspec.filesystem("memory")
    with fs.open(f"{bucket}/{name}", "wb") as f:
        f.write(data)
    return f"memory:/{bucket}/{name}"


class _LocalSource(_LocalFileSource):
    """A registered backend over local files (``local:///abs/path``)."""

    def __init__(self, url: str):
        super().__init__(url[len("local://"):])

    @property
    def name(self) -> str:
        return "local://" + self._path


def _local_lister(url: str) -> list:
    root = url[len("local://"):]
    if os.path.isdir(root):
        return ["local://" + os.path.join(root, f)
                for f in sorted(os.listdir(root))
                if not f.startswith((".", "_"))]
    return [url]


@pytest.fixture
def local_backend():
    register_stream_backend("local", _LocalSource, lister=_local_lister,
                            sizer=lambda u: os.path.getsize(
                                u[len("local://"):]))
    yield "local://"


# -- the remote-scan parity matrix ---------------------------------------


@pytest.mark.parametrize("fmt", ["fixed", "vrl"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_memory_scan_matches_local(tmp_path, fmt, pipeline):
    data, opts = _fmt(fmt, 20000)
    url = _mem_write(data)
    local = str(tmp_path / "local.dat")
    open(local, "wb").write(data)
    if pipeline:
        opts = dict(opts, pipeline_workers="2", chunk_size_mb="0.05",
                    input_split_size_mb="1" if fmt == "vrl" else None)
        opts = {k: v for k, v in opts.items() if v is not None}
    got = _port(url, **opts)
    table = got.to_arrow()
    _table_eq(_port(local, **opts).to_arrow(), table)
    _table_eq(_jax(url, **opts).to_arrow(), table)
    assert io_counters(got)["bytes_fetched"] >= len(data) or \
        io_counters(got)["prefetch_issued"] > 0


@pytest.mark.parametrize("fmt", ["fixed", "vrl"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_registered_local_backend_matches_local(tmp_path, local_backend, fmt,
                                                pipeline):
    """A backend registered by scheme (``local://`` over local files)
    reads through the full io stack; its table equals the plain local
    read's and the JAX package's read of the same URL (fsspec's local
    filesystem there)."""
    pytest.importorskip("fsspec")
    data, opts = _fmt(fmt, 20000)
    path = str(tmp_path / "f.dat")
    open(path, "wb").write(data)
    opts = dict(opts, cache_dir=str(tmp_path / "cache"),
                io_block_mb="0.05", prefetch_blocks="2")
    if pipeline:
        opts.update(pipeline_workers="2", chunk_size_mb="0.05")
    got = _port("local://" + path, **opts)
    table = got.to_arrow()
    _table_eq(_port(path, **opts).to_arrow(), table)
    _table_eq(_jax("local://" + path, **opts).to_arrow(), table)
    assert io_counters(got)["bytes_fetched"] >= len(data)


def test_remote_directory_and_glob_scan():
    fsspec = pytest.importorskip("fsspec")
    fs = fsspec.filesystem("memory")
    bucket = f"/d{uuid.uuid4().hex[:10]}"
    for name, n in (("a.dat", 300), ("b.dat", 200), ("_hidden.dat", 50)):
        with fs.open(f"{bucket}/{name}", "wb") as f:
            f.write(fixed_payload(n))
    for url in (f"memory:/{bucket}", f"memory:/{bucket}/*.dat"):
        got = _port(url, copybook_contents=FIXED_COPYBOOK)
        assert len(got) == 500
        _table_eq(_jax(url, copybook_contents=FIXED_COPYBOOK).to_arrow(),
                  got.to_arrow())


def test_unknown_scheme_stays_actionable():
    with pytest.raises(ValueError) as want:
        _jax("noproto77://bucket/x.dat", copybook_contents=FIXED_COPYBOOK)
    with pytest.raises(ValueError, match="register_stream_backend") as got:
        _port("noproto77://bucket/x.dat", copybook_contents=FIXED_COPYBOOK)
    assert str(got.value) == str(want.value).replace(
        "cobrix_tpu.", "cobrix_tpu_torch.")


def test_missing_remote_file_raises_backend_error():
    pytest.importorskip("fsspec")
    with pytest.raises(FileNotFoundError):
        _port(f"memory://absent-{uuid.uuid4().hex}/x.dat",
              copybook_contents=FIXED_COPYBOOK)


# -- fault injection: the retry machinery against network-shaped failures


@pytest.mark.parametrize("fmt", ["fixed", "vrl"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_flaky_backend_retries_are_ledgered(fmt, pipeline):
    """Transient remote failures are retried (backoff) and the retries
    land on the read's diagnostics ledger; rows are the JAX package's."""
    scheme = f"flky{uuid.uuid4().hex[:8]}"
    data, opts = _fmt(fmt, 2000)
    if pipeline:
        opts = dict(opts, pipeline_workers="2", chunk_size_mb="1")
    opts.update(record_error_policy="permissive", io_retry_attempts="5",
                io_retry_base_delay_ms="1", prefetch_blocks="2",
                io_block_mb="0.05")
    source = register_chaos_backend(scheme, data, fail_reads=2)
    jax_register_chaos_backend(scheme, data, fail_reads=2)
    got = _port(f"{scheme}://f.dat", **opts)
    assert len(got.to_rows()) == 2000
    assert source.failures_served == 2
    assert got.diagnostics.io_retries >= 2
    _table_eq(_jax(f"{scheme}://f.dat", **opts).to_arrow().
              replace_schema_metadata(None),
              got.to_arrow().replace_schema_metadata(None))


def test_retries_under_fail_fast_give_a_ledger():
    """A fail_fast read that retried storage still reports it: the
    ledger exists, with no corrupt record, as in the JAX package."""
    scheme = f"ffr{uuid.uuid4().hex[:8]}"
    data = fixed_payload(500)
    register_chaos_backend(scheme, data, fail_reads=1)
    got = _port(f"{scheme}://f.dat", copybook_contents=FIXED_COPYBOOK,
                io_retry_attempts="3", io_retry_base_delay_ms="1")
    assert len(got) == 500
    assert got.diagnostics.io_retries == 1
    assert got.diagnostics.corrupt_records == 0


def test_dead_backend_fails_with_its_own_error_type():
    scheme = f"dead{uuid.uuid4().hex[:8]}"
    register_chaos_backend(scheme, fixed_payload(100), fail_forever=True,
                           error_type=ConnectionResetError)
    with hard_timeout(60, "dead backend"):
        with pytest.raises(ConnectionResetError):
            _port(f"{scheme}://f.dat", copybook_contents=FIXED_COPYBOOK,
                  io_retry_attempts="2", io_retry_base_delay_ms="1",
                  io_retry_deadline_ms="500")


def test_slow_backend_served_through_prefetch():
    scheme = f"slow{uuid.uuid4().hex[:8]}"
    data = fixed_payload(3000)
    source = register_chaos_backend(scheme, data, latency_s=0.01)
    got = _port(f"{scheme}://f.dat", copybook_contents=FIXED_COPYBOOK,
                prefetch_blocks="3", io_block_mb="0.01")
    assert len(got.to_rows()) == 3000
    assert source.slept_s > 0
    io = io_counters(got)
    assert io["prefetch_issued"] > 0
    assert io["prefetch_hits"] + io["prefetch_waits"] > 0
    assert 0 < io["prefetch_utilization"] <= 1


def test_a_failed_prefetch_reraises_on_the_consumer_under_the_policy(
        tmp_path):
    """A failed prefetch re-raises on the consumer's thread when the
    consumer reaches its blocks, and the consumer's retry policy
    re-issues the read (the pool never retries on its own); with every
    7th backend read failing, prefetch pool reads included, a whole read
    completes with its retries ledgered."""
    import threading
    import time

    from cobrix_tpu_torch.io.prefetch import ReadAheadSource
    from cobrix_tpu_torch.reader.stream import RetryPolicy

    data = bytes(range(256)) * 64
    block = 1024
    failed = threading.Event()

    class _Once(ByteRangeSource):
        def size(self):
            return len(data)

        def read(self, offset, n):
            if offset == block and not failed.is_set():
                time.sleep(0.3)  # the consumer is waiting on it by now
                failed.set()
                raise IOError("injected prefetch failure")
            return data[offset:offset + n]

    retries = []
    f = SourceFile(ReadAheadSource(_Once(), block, 2),
                   retry=RetryPolicy(max_attempts=3, base_delay=0.001),
                   on_retry=lambda: retries.append(1), chunk_size=block)
    buf = bytearray(len(data))
    assert f.readinto(buf) == len(data) and bytes(buf) == data
    # the failed fetch was one coalesced read of blocks 1 and 2: each
    # block re-raises when the consumer reaches it, and is re-read once
    assert failed.is_set() and retries == [1, 1]

    scheme = f"pfx{uuid.uuid4().hex[:8]}"
    rows = fixed_payload(4000)
    source = register_chaos_backend(scheme, rows, fail_every=7)
    got = _port(f"{scheme}://f.dat", copybook_contents=FIXED_COPYBOOK,
                prefetch_blocks="4", io_block_mb="0.005",
                io_retry_attempts="4", io_retry_base_delay_ms="1")
    assert len(got) == 4000 and source.failures_served >= 1
    assert got.diagnostics.io_retries >= source.failures_served
    local = str(tmp_path / "f.dat")
    open(local, "wb").write(rows)
    _table_eq(_port(local, copybook_contents=FIXED_COPYBOOK).to_arrow(),
              got.to_arrow())


def test_truncating_backend_is_ledgered_not_fatal():
    """Storage EOF short of the advertised size: a permissive read
    ledgers the truncation and returns the decodable prefix, with the
    JAX package's rows and ledger."""
    scheme = f"trnc{uuid.uuid4().hex[:8]}"
    data = fixed_payload(1000)
    cut = 500 * FIXED_RECORD_BYTES + 5  # mid-record
    register_chaos_backend(scheme, data, truncate_at=cut)
    jax_register_chaos_backend(scheme, data, truncate_at=cut)
    opts = dict(copybook_contents=FIXED_COPYBOOK,
                record_error_policy="permissive")
    got = _port(f"{scheme}://f.dat", **opts)
    want = _jax(f"{scheme}://f.dat", **opts)
    assert len(got.to_rows()) == 501
    diag = got.diagnostics
    assert diag.corrupt_records == 1
    assert any("truncated" in e.reason for e in diag.entries)
    assert got.to_rows() == want.to_rows()
    assert [(e.offset, e.reason) for e in diag.entries] == \
        [(e.offset, e.reason) for e in want.diagnostics.entries]


# -- the persistent cache planes -----------------------------------------


def test_warm_vrl_rescan_skips_network_and_index_pass(tmp_path):
    """Scan a remote RDW file twice with cache_dir set: the second scan
    makes no index pass (the scan kernel's index pass never runs) and
    serves blocks from disk; a changed file invalidates both planes."""
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    data = vrl_payload(30000)
    url = _mem_write(data)
    kw = dict(copybook_contents=VRL_COPYBOOK, cache_dir=cache,
              prefetch_blocks="2", io_block_mb="0.25",
              input_split_size_mb="1", pipeline_workers="2", **VRL_OPTS)
    cold = _port(url, **kw)
    cold_io = io_counters(cold)
    assert cold_io["index_misses"] >= 1 and cold_io["index_saves"] >= 1
    assert cold_io["bytes_fetched"] >= len(data)
    _table_eq(_jax(url, **kw).to_arrow(), cold.to_arrow())

    calls = []
    real = port_vlr.VarLenReader._generate_index_fast

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)
    port_vlr.VarLenReader._generate_index_fast = spy
    try:
        warm = _port(url, **kw)
    finally:
        port_vlr.VarLenReader._generate_index_fast = real
    warm_io = io_counters(warm)
    assert calls == []
    assert warm_io["index_hits"] >= 1 and warm_io["index_misses"] == 0
    assert warm_io["block_hits"] >= 1
    assert warm_io["bytes_fetched"] == 0
    assert warm.to_arrow().equals(cold.to_arrow())

    fsspec = pytest.importorskip("fsspec")
    with fsspec.filesystem("memory").open(url[len("memory://"):],
                                          "wb") as f:
        f.write(vrl_payload(15000))
    changed = _port(url, **kw)
    ch_io = io_counters(changed)
    assert ch_io["index_hits"] == 0 and ch_io["index_misses"] >= 1
    assert ch_io["bytes_fetched"] > 0
    assert changed.to_arrow().num_rows == 15000


def test_warm_fixed_rescan_serves_from_block_cache(tmp_path):
    cache = str(tmp_path / "cache")
    data = fixed_payload(5000)
    url = _mem_write(data)
    kw = dict(copybook_contents=FIXED_COPYBOOK, cache_dir=cache,
              io_block_mb="0.05")
    cold = _port(url, **kw)
    warm = _port(url, **kw)
    assert io_counters(cold)["bytes_fetched"] >= len(data)
    assert io_counters(warm)["bytes_fetched"] == 0
    assert io_counters(warm)["block_hits"] >= 1
    assert warm.to_arrow().equals(cold.to_arrow())


def test_block_cache_lru_eviction_under_budget(tmp_path):
    cache = str(tmp_path / "cache")
    data = fixed_payload(30000)  # 360 KB
    url = _mem_write(data)
    got = _port(url, copybook_contents=FIXED_COPYBOOK, cache_dir=cache,
                cache_max_mb="0.1", io_block_mb="0.02")
    assert len(got.to_rows()) == 30000
    assert io_counters(got)["block_evictions"] >= 1
    total = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, files in os.walk(cache) for f in files
                if f.endswith(".blk"))
    assert total <= int(0.1 * 1024 * 1024) + int(0.02 * 1024 * 1024)


def test_short_backend_fetch_never_misaligns_cached_blocks(tmp_path):
    """A backend serving FEWER bytes than size() promised while LATER
    blocks sit in the cache: the read surfaces a short read, never the
    cached blocks joined after the gap."""

    class _Mem(ByteRangeSource):
        def __init__(self, payload, cut=None):
            self._p, self._cut = payload, cut

        def size(self):
            return len(self._p)

        def read(self, offset, n):
            if self._cut is not None:
                if offset >= self._cut:
                    return b""
                n = min(n, self._cut - offset)
            return self._p[offset:offset + n]

        def fingerprint(self):
            return "pinned"

        name = "mem://short"

    block = 100
    payload = bytes(range(256)) * 4
    cache = shared_block_cache(str(tmp_path / "c"), 0)
    warm = CachingSource(_Mem(payload), "mem://short", cache, block)
    assert warm.read(0, len(payload)) == payload
    gen = warm._gen_dir
    for start in (0, 100):
        os.unlink(os.path.join(gen, f"{start}-{start + block}.blk"))
    cut = CachingSource(_Mem(payload, cut=150), "mem://short", cache,
                        block)
    assert cut.read(0, len(payload)) == payload[:150]


def test_local_backend_cache_invalidates_on_file_change(tmp_path,
                                                       local_backend):
    cache = str(tmp_path / "cache")
    p = str(tmp_path / "f.dat")
    open(p, "wb").write(fixed_payload(2000))
    kw = dict(copybook_contents=FIXED_COPYBOOK, cache_dir=cache,
              io_block_mb="0.01")
    _port("local://" + p, **kw)
    warm = _port("local://" + p, **kw)
    assert io_counters(warm)["bytes_fetched"] == 0
    with open(p, "wb") as f:
        f.write(fixed_payload(1000))
    changed = _port("local://" + p, **kw)
    assert io_counters(changed)["bytes_fetched"] > 0
    assert changed.to_arrow().num_rows == 1000


_TWO_PROC_DRIVER = """
import json, os, sys
sys.path.insert(0, {repo!r})
import cobrix_tpu_torch as t
from cobrix_tpu_torch.reader.stream import _LocalFileSource


class Local(_LocalFileSource):
    def __init__(self, url):
        super().__init__(url[len("local://"):])


t.register_stream_backend("local", Local)
out = t.read_cobol("local://" + {path!r}, device="cpu",
                   copybook_contents={copybook!r},
                   cache_dir={cache!r}, io_block_mb="0.02",
                   is_record_sequence="true", is_rdw_big_endian="true",
                   input_split_size_mb="1", pipeline_workers="2")
io = out.metrics.as_dict().get("io") or {{}}
print(json.dumps({{"rows": out.to_arrow().num_rows, "io": io}}))
"""


def test_two_processes_share_one_cache_dir(tmp_path, local_backend):
    """Two fresh processes read the same file into the same cache_dir at
    once: both succeed with full row counts (atomic block writes), they
    converge on one generation, and a third warm read serves fully from
    the cache they built."""
    with hard_timeout(180, "two-process cache access"):
        cache = str(tmp_path / "cache")
        p = str(tmp_path / "v.dat")
        open(p, "wb").write(vrl_payload(30000))
        script = _TWO_PROC_DRIVER.format(repo=REPO, path=p,
                                         copybook=VRL_COPYBOOK, cache=cache)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        procs = [subprocess.Popen([sys.executable, "-c", script],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, env=env)
                 for _ in range(2)]
        results = []
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=150)
            assert proc.returncode == 0, stderr.decode()[-2000:]
            results.append(json.loads(stdout))
        assert all(r["rows"] == 30000 for r in results)
        assert len(os.listdir(os.path.join(cache, "blocks"))) == 1
        warm = _port("local://" + p, copybook_contents=VRL_COPYBOOK,
                     cache_dir=cache, io_block_mb="0.02",
                     input_split_size_mb="1", pipeline_workers="2",
                     **VRL_OPTS)
        io = io_counters(warm)
        assert io["bytes_fetched"] == 0 and io["index_hits"] >= 1


def test_flaky_backend_with_cache_and_prefetch(tmp_path):
    """Chaos faults below cache below prefetch: retries recover, blocks
    persist, and the warm read never touches the flaky backend again."""
    scheme = f"chao{uuid.uuid4().hex[:8]}"
    cache = str(tmp_path / "cache")
    data = fixed_payload(3000)
    source = register_chaos_backend(scheme, data, fail_reads=2)
    kw = dict(copybook_contents=FIXED_COPYBOOK, cache_dir=cache,
              prefetch_blocks="2", io_block_mb="0.02",
              io_retry_attempts="5", io_retry_base_delay_ms="1")
    cold = _port(f"{scheme}://f.dat", **kw)
    assert len(cold.to_rows()) == 3000
    assert cold.diagnostics.io_retries >= 2
    calls_after_cold = source.read_calls
    warm = _port(f"{scheme}://f.dat", **kw)
    assert warm.to_rows() == cold.to_rows()
    assert source.read_calls == calls_after_cold
    assert io_counters(warm)["bytes_fetched"] == 0


def test_local_plain_paths_never_touch_io_layer(tmp_path):
    p = str(tmp_path / "f.dat")
    open(p, "wb").write(fixed_payload(500))
    cache = str(tmp_path / "cache")
    got = _port(p, copybook_contents=FIXED_COPYBOOK, cache_dir=cache,
                prefetch_blocks="2")
    assert len(got.to_rows()) == 500
    assert "io" not in got.metrics.as_dict()
    assert not os.path.exists(os.path.join(cache, "blocks")) or \
        not os.listdir(os.path.join(cache, "blocks"))


# -- the stream layer (tests/test_stream_backends.py) ------------------


class FakeRemoteSource(ByteRangeSource):
    """In-memory 'remote' object store that logs (offset, n) of every
    read and can serve short reads."""

    store = {}

    def __init__(self, path: str, max_read: int = 0):
        self._path = path
        self._data = self.store[path]
        self._max_read = max_read
        self.reads = []

    def size(self) -> int:
        return len(self._data)

    def read(self, offset: int, n: int) -> bytes:
        self.reads.append((offset, n))
        if self._max_read:
            n = min(n, self._max_read)
        return self._data[offset:offset + n]

    @property
    def name(self) -> str:
        return self._path


def _fake(data: bytes, max_read: int = 0) -> FakeRemoteSource:
    FakeRemoteSource.store["fake://x"] = data
    return FakeRemoteSource("fake://x", max_read)


def test_path_scheme():
    assert path_scheme("s3://bucket/key") == "s3"
    assert path_scheme("file:///tmp/x") == "file"
    assert path_scheme("/tmp/x") is None
    assert path_scheme("C://odd") is None


def test_unregistered_scheme_raises():
    with pytest.raises(ValueError, match="No stream backend"):
        open_stream("nosuch://x/y")


def test_buffered_stream_seek_bounded_chunked():
    data = bytes(range(256)) * 100
    src = _fake(data)
    stream = BufferedSourceStream(src, start_offset=1000,
                                  maximum_bytes=5000, chunk_size=2048)
    assert stream.offset == 1000
    assert stream.size() == 6000
    assert stream.true_size == len(data)
    got = b""
    while not stream.is_end_of_stream:
        got += stream.next(100)
    assert got == data[1000:6000]
    assert len(src.reads) == 3
    assert src.reads[0] == (1000, 2048)
    assert stream.next(10) == b""


def test_buffered_stream_refills_on_short_reads():
    data = b"AB" * 5000
    src = _fake(data, max_read=700)
    stream = BufferedSourceStream(src, chunk_size=4096)
    assert stream.next(6000) == data[:6000]
    assert len(src.reads) >= 6


def test_buffered_stream_gives_the_bytes_before_its_offset():
    """`preceding` on a buffered (and so a decompressing) stream: from
    its buffer, or read from the source before a shard's start."""
    data = bytes(range(256)) * 40
    stream = BufferedSourceStream(_fake(data), start_offset=3000,
                                  chunk_size=512)
    assert stream.preceding(5) == data[2995:3000]
    stream.next(700)
    assert stream.preceding(9) == data[3691:3700]
    assert BufferedSourceStream(_fake(data)).preceding(4) == b""


def test_source_file_seeks_and_reads_into_buffers():
    import numpy as np

    data = bytes(range(256)) * 40
    f = SourceFile(_fake(data, max_read=333))
    assert f.size() == len(data)
    f.seek(1000)
    buf = np.empty(2000, dtype=np.uint8)
    assert f.readinto(memoryview(buf)) == 2000 and f.tell() == 3000
    assert buf.tobytes() == data[1000:3000]
    assert f.pread(6, 10) == data[10:16] and f.tell() == 3000
    f.seek(len(data) - 10)
    assert f.readinto(memoryview(buf)) == 10


def test_end_to_end_read_through_registered_backend(tmp_path):
    """read_cobol over a scheme path: RDW multisegment decode through the
    buffered remote stream equals the local read and the JAX package's
    read of the same bytes."""
    from cobrix_tpu import register_stream_backend as jax_register

    register_stream_backend("fake", FakeRemoteSource)
    raw = pgen.generate_exp2(3000, seed=6)
    FakeRemoteSource.store["fake://bucket/exp2.dat"] = raw

    class JaxFake(cobrix_tpu.ByteRangeSource):
        def __init__(self, path):
            self._data = FakeRemoteSource.store[path]

        def size(self):
            return len(self._data)

        def read(self, offset, n):
            return self._data[offset:offset + n]

    jax_register("fake", JaxFake)
    kw = dict(copybook_contents=pgen.EXP2_COPYBOOK,
              is_record_sequence="true", segment_field="SEGMENT-ID",
              redefine_segment_id_map="STATIC-DETAILS => C",
              redefine_segment_id_map_1="CONTACTS => P",
              segment_id_prefix="R", generate_record_id="true")
    remote = _port("fake://bucket/exp2.dat", **kw).to_arrow()
    p = str(tmp_path / "exp2.dat")
    open(p, "wb").write(raw)
    assert remote.num_rows == 3000
    _table_eq(_port(p, **kw).to_arrow(), remote)
    _table_eq(_jax("fake://bucket/exp2.dat", **kw).to_arrow(), remote)
