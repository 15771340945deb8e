"""The port's self-verifying cache planes (io/integrity.py).

Mirrors tests/test_integrity.py on the CPU: every persisted artifact the
port trusts across processes — block-cache entries, sparse-index
payloads, inflate indexes — verifies on read; a flipped bit, a torn tail
or foreign bytes is quarantined, counted (on the read and in the
process counter) and rebuilt, never decoded into wrong rows; a cache
volume that cannot be written degrades to direct reads. Each healed
read's table equals the clean read's, which equals the JAX package's.
"""
import errno
import json
import os
import uuid

import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu_torch.io import blockcache, compress_index, index_store
from cobrix_tpu_torch.io.blockcache import BlockCache
from cobrix_tpu_torch.io.integrity import (corruption_counter, frame_block,
                                           sweep_cache_root, unframe_block,
                                           verify_json_payload)
from cobrix_tpu_torch.io.stats import IoStats
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing.faults import (cache_entry_paths,
                                             corrupt_cache_entry,
                                             register_chaos_backend)
from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                 EXP2_COPYBOOK,
                                                 generate_exp1,
                                                 generate_exp2)

from util import hard_timeout

warm_pyarrow()

MODES = [("sequential", {"pipeline_workers": "0"}),
         ("pipelined", {"pipeline_workers": "2"})]

VRL_OPTS = dict(copybook_contents=EXP2_COPYBOOK,
                is_record_sequence="true",
                segment_field="SEGMENT-ID", segment_id_prefix="I",
                redefine_segment_id_map="STATIC-DETAILS => C",
                **{"redefine_segment_id_map:1": "CONTACTS => P"})


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(180, request.node.name):
        yield


def _port(path, **opts):
    return cobrix_tpu_torch.read_cobol(path, device="cpu", **opts)


def _fixed_scheme(data: bytes) -> str:
    scheme = f"integ{uuid.uuid4().hex[:10]}"
    register_chaos_backend(scheme, data)
    return f"{scheme}://input"


@pytest.fixture(scope="module")
def fixed_data():
    return generate_exp1(600, seed=7).tobytes()


@pytest.fixture(scope="module")
def vrl_file(tmp_path_factory):
    # ~2.6 MB against a 1 MB split: several sparse-index entries, so a
    # flipped entry OFFSET is a real misframing hazard
    path = tmp_path_factory.mktemp("integ") / "vrl.dat"
    path.write_bytes(generate_exp2(40000, seed=9))
    return str(path)


# -- block-cache corruption ----------------------------------------------


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "garbage"])
@pytest.mark.parametrize("exec_name,exec_opts", MODES)
def test_block_corruption_self_heals(tmp_path, fixed_data, mode,
                                     exec_name, exec_opts):
    cache_dir = str(tmp_path / "cache")
    url = _fixed_scheme(fixed_data)
    opts = dict(copybook_contents=EXP1_COPYBOOK, cache_dir=cache_dir,
                io_block_mb="0.25", prefetch_blocks="0", **exec_opts)
    clean = _port(url, **opts).to_arrow()
    local = str(tmp_path / "e1.dat")
    open(local, "wb").write(fixed_data)
    assert clean.equals(cobrix_tpu.read_cobol(
        local, copybook_contents=EXP1_COPYBOOK, backend="numpy",
        parallelism="1").to_arrow())
    assert cache_entry_paths(cache_dir, "block")

    corrupted = corrupt_cache_entry(cache_dir, "block", mode)
    healed = _port(url, **opts)
    assert healed.to_arrow().equals(clean)
    assert healed.metrics.as_dict()["io"]["block_corrupt"] >= 1
    assert os.listdir(os.path.join(cache_dir, "quarantine"))
    start, end = (int(x) for x in
                  os.path.basename(corrupted)[:-4].split("-"))
    assert unframe_block(open(corrupted, "rb").read(),
                         end - start) is not None
    warm = _port(url, **opts)
    assert warm.to_arrow().equals(clean)
    warm_io = warm.metrics.as_dict()["io"]
    assert warm_io["block_corrupt"] == 0 and warm_io["block_hits"] > 0


def test_block_corruption_counts_in_the_process_counter(tmp_path,
                                                       fixed_data):
    cache_dir = str(tmp_path / "cache")
    url = _fixed_scheme(fixed_data)
    opts = dict(copybook_contents=EXP1_COPYBOOK, cache_dir=cache_dir,
                io_block_mb="0.25", prefetch_blocks="0")
    _port(url, **opts)
    before = corruption_counter().value("block")
    corrupt_cache_entry(cache_dir, "block", "bitflip")
    _port(url, **opts)
    assert corruption_counter().value("block") == before + 1


def test_short_block_file_is_miss_never_served(tmp_path):
    cache = BlockCache(str(tmp_path))
    gen = cache.generation_dir("mem://x", "fp")
    stats = IoStats()
    payload = os.urandom(4096)
    cache.put(gen, 0, 4096, payload, io_stats=stats)
    path = cache_entry_paths(str(tmp_path), "block")[0]
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 3])
    assert cache.get(gen, 0, 4096, io_stats=stats) is None
    assert stats.as_dict()["block_corrupt"] == 1
    assert not os.path.exists(path)
    cache.put(gen, 0, 4096, payload, io_stats=stats)
    assert cache.get(gen, 0, 4096, io_stats=stats) == payload


def test_block_frame_roundtrip_and_rejects():
    payload = b"some block payload" * 100
    framed = frame_block(payload)
    assert unframe_block(framed, len(payload)) == payload
    bad = bytearray(framed)
    bad[-1] ^= 1
    assert unframe_block(bytes(bad), len(payload)) is None
    bad = bytearray(framed)
    bad[5] ^= 1
    assert unframe_block(bytes(bad), len(payload)) is None
    assert unframe_block(framed, len(payload) - 1) is None
    assert unframe_block(payload, len(payload)) is None


# -- sparse-index corruption ---------------------------------------------


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
@pytest.mark.parametrize("exec_name,exec_opts", MODES)
def test_index_corruption_self_heals(tmp_path, vrl_file, mode,
                                     exec_name, exec_opts):
    cache_dir = str(tmp_path / "cache")
    opts = dict(VRL_OPTS, cache_dir=cache_dir, input_split_size_mb="1",
                **exec_opts)
    clean = _port(vrl_file, **opts)
    assert clean.metrics.as_dict()["io"]["index_saves"] >= 1
    clean_table = clean.to_arrow()
    if exec_name == "pipelined":
        # the JAX package's read keeps its own cache_dir: its index
        # payload must not sit beside the port's, where the corruption
        # below could pick it in place of the port's
        jax_opts = dict(opts, cache_dir=str(tmp_path / "jax_cache"))
        assert clean_table.equals(cobrix_tpu.read_cobol(
            vrl_file, backend="numpy", parallelism="1",
            **jax_opts).to_arrow())
    corrupted = corrupt_cache_entry(cache_dir, "index", mode, offset=-30)
    healed = _port(vrl_file, **opts)
    assert healed.to_arrow().equals(clean_table)
    io = healed.metrics.as_dict()["io"]
    assert io["index_corrupt"] >= 1 and io["index_saves"] >= 1
    assert os.listdir(os.path.join(cache_dir, "quarantine"))
    assert verify_json_payload(
        json.loads(open(corrupted, encoding="utf-8").read()))
    warm = _port(vrl_file, **opts)
    assert warm.to_arrow().equals(clean_table)
    warm_io = warm.metrics.as_dict()["io"]
    assert warm_io["index_corrupt"] == 0 and warm_io["index_hits"] >= 1


def test_index_bitflip_inside_offsets_never_misframes(tmp_path, vrl_file):
    """A flipped digit INSIDE an entry's offsets still deserializes; only
    the checksum knows, and the read must not frame from wrong offsets."""
    cache_dir = str(tmp_path / "cache")
    opts = dict(VRL_OPTS, cache_dir=cache_dir, input_split_size_mb="1",
                pipeline_workers="2")
    clean = _port(vrl_file, **opts).to_arrow()
    path = cache_entry_paths(cache_dir, "index")[0]
    doc = open(path, encoding="utf-8").read()
    payload = json.loads(doc)
    assert len(payload["entries"]) >= 2
    off = payload["entries"][1][0]
    mutated = doc.replace(f"[{off},", f"[{off + 64},", 1)
    assert mutated != doc
    with open(path, "w", encoding="utf-8") as f:
        f.write(mutated)
    healed = _port(vrl_file, **opts)
    assert healed.to_arrow().equals(clean)
    assert healed.metrics.as_dict()["io"]["index_corrupt"] >= 1


def test_index_keys_differ_by_configuration_and_package(tmp_path,
                                                        vrl_file):
    """The config fingerprint covers the split knobs and the copybook: a
    read with another split size or copybook misses; so does the JAX
    package's store over the same cache_dir."""
    cache_dir = str(tmp_path / "cache")
    opts = dict(VRL_OPTS, cache_dir=cache_dir, pipeline_workers="2")
    _port(vrl_file, input_split_size_mb="1", **opts)
    other = _port(vrl_file, input_split_size_mb="2", **opts)
    assert other.metrics.as_dict()["io"]["index_misses"] == 1
    same = _port(vrl_file, input_split_size_mb="1", **opts)
    assert same.metrics.as_dict()["io"]["index_hits"] == 1
    jax = cobrix_tpu.read_cobol(vrl_file, backend="numpy",
                                input_split_size_mb="1", **opts)
    assert jax.metrics.as_dict()["io"]["index_hits"] == 0
    assert jax.to_arrow().equals(same.to_arrow())


# -- cache-volume faults -------------------------------------------------


@pytest.mark.parametrize("fault", ["enospc", "readonly"])
def test_cache_write_faults_degrade_not_fail(tmp_path, fixed_data, fault,
                                             monkeypatch):
    """Every cache-plane write fails as a full or read-only volume does:
    the read is unchanged, leaves no temp files, and the cache works
    again once the volume recovers."""
    cache_dir = str(tmp_path / "cache")
    url = _fixed_scheme(fixed_data)
    opts = dict(copybook_contents=EXP1_COPYBOOK, cache_dir=cache_dir,
                io_block_mb="0.25", prefetch_blocks="0")
    baseline = _port(url, **dict(opts, cache_dir="")).to_arrow()
    code = errno.ENOSPC if fault == "enospc" else errno.EROFS
    attempts = []

    def failing(path, data, fsync=False):
        attempts.append(path)
        raise OSError(code, os.strerror(code), path)
    for module in (blockcache, index_store, compress_index):
        monkeypatch.setattr(module, "write_atomic", failing)
    assert _port(url, **opts).to_arrow().equals(baseline)
    assert attempts
    monkeypatch.undo()
    for dirpath, _d, files in os.walk(cache_dir):
        assert not [n for n in files if n.startswith(".tmp-")]
    assert _port(url, **opts).to_arrow().equals(baseline)


def test_unwritable_cache_volume_degrades(tmp_path, fixed_data):
    ro_root = tmp_path / "ro"
    ro_root.mkdir()
    os.chmod(ro_root, 0o555)
    if os.access(str(ro_root), os.W_OK) or os.geteuid() == 0:
        pytest.skip("cannot drop write permission (running as root)")
    url = _fixed_scheme(fixed_data)
    t = _port(url, copybook_contents=EXP1_COPYBOOK,
              cache_dir=str(ro_root / "cache"), io_block_mb="0.25")
    assert len(t) == 600


# -- crash-consistency sweep ---------------------------------------------


def test_sweep_removes_orphans_and_torn_entries(tmp_path):
    root = tmp_path / "blocks"
    gen = root / "aaaa-bbbb"
    gen.mkdir(parents=True)
    stale_tmp = gen / ".tmp-dead"
    stale_tmp.write_bytes(b"partial")
    os.utime(stale_tmp, (1, 1))
    fresh_tmp = gen / ".tmp-live"
    fresh_tmp.write_bytes(b"inflight")
    torn = gen / "0-4096.blk"
    torn.write_bytes(b"abc")
    good = gen / "4096-8192.blk"
    good.write_bytes(frame_block(b"x" * 4096))
    removed = sweep_cache_root(str(root))
    assert removed == {"tmp_orphans": 1, "truncated": 1}
    assert not stale_tmp.exists() and fresh_tmp.exists()
    assert not torn.exists() and good.exists()


def test_blockcache_open_runs_sweep(tmp_path):
    root = tmp_path / "blocks"
    root.mkdir()
    orphan = root / ".tmp-orphan"
    orphan.write_bytes(b"x")
    os.utime(orphan, (1, 1))
    BlockCache(str(tmp_path))
    assert not orphan.exists()
