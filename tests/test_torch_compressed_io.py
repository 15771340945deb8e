"""The port's compressed-feed ingestion against the JAX package's.

Mirrors tests/test_compressed_io.py on the CPU: a compressed feed is a
transparent view of its decompressed bytes, so every read of one —
sequential or pipelined, fixed-length, RDW multisegment, hierarchical
or text split by the sparse index — must give the table of the port's
read of the uncompressed file AND the table of ``cobrix_tpu.read_cobol``
(numpy backend) of the same compressed input, column for column. A warm
re-read over a ``cache_dir`` inflates nothing; damage in the wire bytes
raises the JAX package's ``CompressedStreamError`` (same codec and both
offsets) under fail_fast, and gives its ledger under permissive; the
persisted inflate index and decompressed blocks self-heal.

zstd cases skip visibly where ``zstandard`` does not import.
"""
import bz2
import gzip
import lzma
import math
import os
import re
import sys
import zlib

import numpy as np
import pytest
import torch

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.io.compress import CompressedStreamError as JaxDamage
from cobrix_tpu_torch import api as port_api
from cobrix_tpu_torch.io.compress import (
    CompressedStreamError,
    codec_by_name,
    codec_for_path,
    compressed_chunkable,
    known_codecs,
    sniff_magic,
)
from cobrix_tpu_torch.io.config import IoConfig
from cobrix_tpu_torch.reader import var_len_reader as port_vlr
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.testing import generators as pgen
from cobrix_tpu_torch.testing.corpus import (
    fixed_read_options,
    multiseg_read_options,
    write_fixed_corpus,
    write_multiseg_corpus,
)
from cobrix_tpu_torch.testing.faults import (
    corrupt_cache_entry,
    corrupt_compressed_trailer,
    garbage_between_members,
    truncate_compressed_member,
)

from util import hard_timeout

warm_pyarrow()

RECORDS = 6000
CHUNK_RECORDS = 1500  # 4 members per corpus — several restart points


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(240, request.node.name):
        yield


def _table_eq(a, b):
    """Equal row count and columns (File_Name excepted: the path string
    is the one column allowed to differ)."""
    assert a.num_rows == b.num_rows
    assert a.column_names == b.column_names
    for name in a.column_names:
        if "File_Name" in name:
            continue
        assert a.column(name).equals(b.column(name)), name


def _port(path, **opts):
    return cobrix_tpu_torch.read_cobol(path, device="cpu", **opts)


def _jax(path, **opts):
    return cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                 **opts)


def _parity(raw, feed, opts, raw_opts=None):
    """The port's read of `feed` equals its read of `raw` and the JAX
    package's read of `feed`; returns the port's CobolData."""
    got = _port(feed, **opts)
    table = got.to_arrow()
    _table_eq(_port(raw, **(raw_opts or opts)).to_arrow(), table)
    _table_eq(_jax(feed, **opts).to_arrow(), table)
    return got


@pytest.fixture(scope="module")
def fixed_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("comp-fixed")
    raw = str(d / "txn.dat")
    gz = str(d / "txn.dat.gz")
    write_fixed_corpus(raw, RECORDS, seed=11, chunk_records=CHUNK_RECORDS)
    write_fixed_corpus(gz, RECORDS, seed=11, chunk_records=CHUNK_RECORDS,
                       compression="gzip")
    return raw, gz


@pytest.fixture(scope="module")
def multiseg_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("comp-vrl")
    raw = str(d / "co.dat")
    gz = str(d / "co.dat.gz")
    write_multiseg_corpus(raw, 1500, seed=11, chunk_companies=400)
    write_multiseg_corpus(gz, 1500, seed=11, chunk_companies=400,
                          compression="gzip")
    return raw, gz


# -- codec registry + detection -------------------------------------------


def test_registry_knows_the_builtin_codecs():
    names = known_codecs()
    for name in ("gzip", "zlib", "bz2", "xz", "zstd"):
        assert name in names
    assert codec_by_name("gz").name == "gzip"
    assert codec_by_name("bzip2").name == "bz2"
    assert codec_by_name("zstandard").name == "zstd"
    assert codec_by_name("deflate").name == "zlib"
    with pytest.raises(ValueError, match="gzip"):
        codec_by_name("snappy")


def test_magic_sniffing_is_strict():
    assert sniff_magic(gzip.compress(b"x")[:6]).name == "gzip"
    assert sniff_magic(b"BZh91AY").name == "bz2"
    assert sniff_magic(b"\x28\xb5\x2f\xfd\x00\x00").name == "zstd"
    assert sniff_magic(b"\xfd7zXZ\x00").name == "xz"
    assert sniff_magic(b"\x1f\x8b\xff\xff\xff\xff") is None
    assert sniff_magic(b"\x1f\x8b\x08\xe0\x00\x00") is None
    assert sniff_magic(b"") is None
    assert sniff_magic(zlib.compress(b"x")[:6]) is None


def test_extension_mapping():
    assert codec_for_path("a/b.dat.gz").name == "gzip"
    assert codec_for_path("a/b.GZ").name == "gzip"
    assert codec_for_path("x.bz2").name == "bz2"
    assert codec_for_path("x.zst").name == "zstd"
    assert codec_for_path("x.xz").name == "xz"
    assert codec_for_path("x.zz").name == "zlib"
    assert codec_for_path("x.dat") is None


@pytest.mark.parametrize("option,value", [
    ("compression", "snappy"), ("compress_block_mb", "0"),
    ("cache_max_mb", "-1"), ("prefetch_blocks", "-1"),
    ("io_block_mb", "0"), ("io_retry_attempts", "0"),
    ("cache_dir", "/no/such/parent/cache")])
def test_api_option_validation(fixed_pair, option, value):
    """The I/O options are parsed and checked with the JAX package's
    messages."""
    raw, _gz = fixed_pair
    opts = dict(fixed_read_options(), **{option: value})
    with pytest.raises(ValueError) as want:
        _jax(raw, **opts)
    with pytest.raises(ValueError) as got:
        _port(raw, **opts)
    assert option in str(got.value)
    assert str(got.value) == str(want.value)


def test_compressed_files_single_shard_without_cache(fixed_pair, tmp_path):
    _raw, gz = fixed_pair
    assert compressed_chunkable(gz, None) is False
    assert compressed_chunkable(gz, IoConfig(cache_dir=str(tmp_path)))
    assert compressed_chunkable("plain.dat", None) is True


# -- the parity matrix -----------------------------------------------------


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_fixed_parity(fixed_pair, tmp_path, mode):
    raw, gz = fixed_pair
    opts = fixed_read_options()
    if mode == "pipelined":
        opts.update(pipeline_workers="2", chunk_size_mb="0.1",
                    cache_dir=str(tmp_path / "cache"),
                    compress_block_mb="0.25")
    got = _parity(raw, gz, opts)
    assert len(got) == RECORDS
    io = got.metrics.as_dict()["io"]
    assert io["decompressed_bytes_out"] > 0
    assert got.metrics.as_dict()["bytes_read"] == os.path.getsize(raw)
    if mode == "pipelined":
        # the cache plane lets the pipelined read split the feed as the
        # raw file's chunks
        assert got.metrics.as_dict()["shards"] > 1


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_vrl_parity(multiseg_pair, tmp_path, mode):
    raw, gz = multiseg_pair
    opts = dict(multiseg_read_options(), segment_id_prefix="Z")
    if mode == "pipelined":
        opts.update(pipeline_workers="2", input_split_size_mb="1",
                    cache_dir=str(tmp_path / "cache"),
                    compress_block_mb="0.25")
    got = _parity(raw, gz, opts)
    assert got.metrics.as_dict()["io"]["decompressed_bytes_out"] > 0


def test_streams_one_feed_in_chunks_and_windows(fixed_pair, multiseg_pair,
                                                monkeypatch):
    """Without a cache_dir the JAX package reads a compressed file as one
    whole-file result; the port streams it in record-aligned chunks (the
    fixed route) or scan windows (the RDW route) through one
    decompressing stream, with the same rows and Record_Ids."""
    raw, gz = fixed_pair
    monkeypatch.setattr(port_api, "FIXED_READ_CHUNK_BYTES", 35 * 700)
    got = _parity(raw, gz, fixed_read_options())
    assert len(got.batches) == math.ceil(RECORDS / 700)
    monkeypatch.setattr(port_vlr, "READ_WINDOW_BYTES", 20000)
    for route_opts in (dict(fixed_read_options(), generate_record_id="true"),
                       dict(multiseg_read_options(), segment_id_prefix="W",
                            generate_record_id="true",
                            segment_id_level0="C", segment_id_level1="P")):
        src = raw if "is_record_sequence" not in route_opts \
            else multiseg_pair[0]
        feed = gz if src == raw else multiseg_pair[1]
        got = _parity(src, feed, route_opts)
        ids = got.to_arrow().column("Record_Id").to_numpy()
        assert (np.diff(ids) == 1).all()


@pytest.mark.parametrize("codec,ext", [("bz2", "bz2"), ("xz", "xz"),
                                       ("zlib", "zz"), ("zstd", "zst")])
def test_other_codecs_fixed_parity(fixed_pair, tmp_path, codec, ext):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    raw, _gz = fixed_pair
    path = str(tmp_path / f"txn.dat.{ext}")
    write_fixed_corpus(path, RECORDS, seed=11,
                       chunk_records=CHUNK_RECORDS, compression=codec)
    _parity(raw, path, fixed_read_options())
    # and pinned on a name that says nothing
    hidden = str(tmp_path / "feed.bin")
    os.replace(path, hidden)
    _parity(raw, hidden, dict(fixed_read_options(), compression=codec),
            raw_opts=fixed_read_options())


def test_pinned_and_disabled_compression(fixed_pair, tmp_path):
    raw, _gz = fixed_pair
    base = fixed_read_options()
    # pinned codec on an extensionless name (zlib has no magic either)
    hidden = str(tmp_path / "feed.bin")
    with open(hidden, "wb") as f:
        f.write(zlib.compress(open(raw, "rb").read()))
    _parity(raw, hidden, dict(base, compression="zlib"), raw_opts=base)
    # compression=none reads a RAW file through a .gz name untouched
    misnamed = str(tmp_path / "raw.dat.gz")
    with open(misnamed, "wb") as f:
        f.write(open(raw, "rb").read())
    _parity(raw, misnamed, dict(base, compression="none"), raw_opts=base)
    # and auto mode sniffs: the magic veto overrides the extension
    got = _parity(raw, misnamed, base)
    assert "io" not in got.metrics.as_dict()


# -- hierarchical and text inputs -------------------------------------------


def _hier_opts():
    o = {f"redefine_segment_id_map:{i}": f"{n} => {s}" for i, (s, n) in
         enumerate(pgen.HIERARCHICAL_SEGMENT_MAP.items())}
    o.update({f"segment-children:{i}": f"{p} => {c}" for i, (c, p) in
              enumerate(pgen.HIERARCHICAL_PARENT_MAP.items())})
    return dict(copybook_contents=pgen.HIERARCHICAL_COPYBOOK,
                is_record_sequence="true", segment_field="SEGMENT-ID",
                generate_record_id="true", **o)


@pytest.mark.parametrize("split", [False, True])
def test_hierarchical_gzip_parity(tmp_path, split):
    data = pgen.generate_hierarchical(300, seed=5)
    raw = str(tmp_path / "h.dat")
    gz = str(tmp_path / "h.dat.gz")
    open(raw, "wb").write(data)
    cut = len(data) // 3
    open(gz, "wb").write(gzip.compress(data[:cut]) + gzip.compress(
        data[cut:]))
    opts = _hier_opts()
    if split:
        opts.update(input_split_records="100",
                    cache_dir=str(tmp_path / "cache"),
                    compress_block_mb="0.0625")
    got = _parity(raw, gz, opts)
    assert got.to_json_lines() == _jax(gz, **opts).to_json_lines()
    # without a cache_dir the feed is one shard; with one, the index's
    assert (len(got.results) > 1) == split


def test_text_split_by_sparse_index_from_gzip(tmp_path):
    """A text file read in the sparse index's shards from a gzip feed
    (with a cache_dir, so the feed splits): each shard starts from the
    line end before it, read from the decompressed bytes (ROADMAP C8)."""
    data = pgen.generate_text(3000, seed=8)
    raw = str(tmp_path / "t.txt")
    gz = str(tmp_path / "t.txt.gz")
    open(raw, "wb").write(data)
    third = len(data) // 3
    open(gz, "wb").write(b"".join(
        gzip.compress(data[i:i + third]) for i in range(0, len(data), third)))
    opts = dict(copybook_contents=pgen.TEXT_COPYBOOK, is_text="true",
                encoding="ascii", input_split_records="700",
                generate_record_id="true",
                cache_dir=str(tmp_path / "cache"),
                compress_block_mb="0.0625")
    got = _parity(raw, gz, opts)
    assert len(got.results) > 1
    assert len(got) == 3000


# -- post-decompression caching -------------------------------------------


def test_warm_scan_skips_inflate_entirely(fixed_pair, tmp_path):
    raw, gz = fixed_pair
    cache = str(tmp_path / "cache")
    cold_opts = dict(fixed_read_options(), cache_dir=cache,
                     compress_block_mb="0.25", pipeline_workers="2",
                     chunk_size_mb="0.1")
    cold = _parity(raw, gz, cold_opts, raw_opts=fixed_read_options())
    cold_io = cold.metrics.as_dict()["io"]
    assert cold_io["decompressed_bytes_out"] > 0
    assert cold_io["compressed_bytes_in"] > 0
    # warm sequential scan over the cache the pipelined run populated:
    # ZERO inflate work, each planned block served from the cache once
    warm = _port(gz, **dict(fixed_read_options(), cache_dir=cache,
                            compress_block_mb="0.25"))
    _table_eq(_port(raw, **fixed_read_options()).to_arrow(),
              warm.to_arrow())
    io = warm.metrics.as_dict()["io"]
    assert io["decompressed_bytes_out"] == 0
    assert io["compressed_bytes_in"] == 0
    block = int(0.25 * 1024 * 1024)
    assert io["inflate_skipped"] == math.ceil(os.path.getsize(raw) / block)
    # and the warm pipelined read as well
    again = _port(gz, **cold_opts)
    assert again.metrics.as_dict()["io"]["compressed_bytes_in"] == 0


def test_warm_rdw_rescan_skips_inflate_and_index_pass(multiseg_pair,
                                                     tmp_path):
    raw, gz = multiseg_pair
    opts = dict(multiseg_read_options(), segment_id_prefix="Q",
                pipeline_workers="2", input_split_size_mb="1",
                cache_dir=str(tmp_path / "cache"), compress_block_mb="0.25")
    cold = _parity(raw, gz, opts)
    cio = cold.metrics.as_dict()["io"]
    assert cio["index_misses"] == 1 and cio["index_saves"] == 1
    calls = []
    real = port_vlr.VarLenReader._generate_index_fast

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)
    port_vlr.VarLenReader._generate_index_fast = spy
    try:
        warm = _port(gz, **opts)
    finally:
        port_vlr.VarLenReader._generate_index_fast = real
    _table_eq(cold.to_arrow(), warm.to_arrow())
    wio = warm.metrics.as_dict()["io"]
    assert calls == [] and wio["index_hits"] == 1
    assert wio["compressed_bytes_in"] == 0
    assert wio["inflate_skipped"] >= 1


def test_inflate_index_survives_corruption(fixed_pair, tmp_path):
    raw, gz = fixed_pair
    cache = str(tmp_path / "cache")
    opts = dict(fixed_read_options(), cache_dir=cache,
                compress_block_mb="0.25")
    _parity(raw, gz, opts, raw_opts=fixed_read_options())
    corrupt_cache_entry(cache, "compress", "bitflip")
    healed = _port(gz, **opts)
    _table_eq(_port(raw, **fixed_read_options()).to_arrow(),
              healed.to_arrow())
    assert healed.metrics.as_dict()["io"]["compress_corrupt"] >= 1
    assert os.listdir(os.path.join(cache, "quarantine"))
    clean = _port(gz, **opts)
    _table_eq(healed.to_arrow(), clean.to_arrow())
    assert clean.metrics.as_dict()["io"]["compress_corrupt"] == 0


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "garbage"])
def test_decompressed_block_corruption_self_heals(fixed_pair, tmp_path,
                                                  mode):
    raw, gz = fixed_pair
    cache = str(tmp_path / "cache")
    opts = dict(fixed_read_options(), cache_dir=cache,
                compress_block_mb="0.25")
    base = _port(raw, **fixed_read_options()).to_arrow()
    _table_eq(base, _port(gz, **opts).to_arrow())
    corrupt_cache_entry(cache, "block", mode, which=1)
    healed = _port(gz, **opts)
    _table_eq(base, healed.to_arrow())
    assert healed.metrics.as_dict()["io"]["block_corrupt"] == 1


# -- damage taxonomy -------------------------------------------------------


def _damaged(tmp_path, src, injector, label, ext="dat.gz"):
    bad, off = injector(open(src, "rb").read())
    path = str(tmp_path / f"{label}.{ext}")
    with open(path, "wb") as f:
        f.write(bad)
    return path, off


@pytest.mark.parametrize("injector,label", [
    (truncate_compressed_member, "torn"),
    (corrupt_compressed_trailer, "crc"),
    (garbage_between_members, "spliced"),
])
@pytest.mark.parametrize("framing", ["fixed", "rdw"])
def test_damage_fails_fast_with_both_offsets(fixed_pair, multiseg_pair,
                                             tmp_path, injector, label,
                                             framing):
    src = fixed_pair[1] if framing == "fixed" else multiseg_pair[1]
    opts = (fixed_read_options() if framing == "fixed"
            else dict(multiseg_read_options(), segment_id_prefix="D"))
    path, _off = _damaged(tmp_path, src, injector, label)
    with pytest.raises(JaxDamage) as want:
        _jax(path, **opts).to_arrow()
    with pytest.raises(CompressedStreamError) as got:
        _port(path, **opts).to_arrow()
    w, g = want.value, got.value
    assert g.codec == "gzip" and g.compressed_offset >= 0 \
        and g.decompressed_offset >= 0
    assert (str(g), g.codec, g.compressed_offset, g.decompressed_offset) \
        == (str(w), w.codec, w.compressed_offset, w.decompressed_offset)


@pytest.mark.parametrize("framing", ["fixed", "rdw"])
def test_truncated_member_permissive_keeps_clean_prefix(fixed_pair,
                                                        multiseg_pair,
                                                        tmp_path, framing):
    """The torn tail is ledgered as on a truncated raw file; rows and
    ledger (entries, offsets) equal the JAX package's."""
    src = fixed_pair[1] if framing == "fixed" else multiseg_pair[1]
    opts = (fixed_read_options() if framing == "fixed"
            else dict(multiseg_read_options(), segment_id_prefix="T"))
    opts.update(record_error_policy="permissive")
    path, _cut = _damaged(tmp_path, src, truncate_compressed_member,
                          "torn-perm")
    want = _jax(path, **opts)
    got = _port(path, **opts)
    table = got.to_arrow()
    _table_eq(want.to_arrow(), table)
    assert got.diagnostics.as_dict() == want.diagnostics.as_dict()
    assert got.diagnostics.corrupt_records >= (1 if framing == "fixed"
                                               else 0)
    assert got.metrics.as_dict()["io"]["compress_corrupt"] >= 1
    clean = _port(src, **opts).to_arrow()
    assert 0 < table.num_rows < clean.num_rows


# -- zstd visibility -------------------------------------------------------


def test_zstd_without_package_is_actionable(tmp_path, monkeypatch):
    """Where ``zstandard`` does not import, a zstd feed raises the JAX
    package's actionable ImportError — never a read of the raw bytes."""
    monkeypatch.setitem(sys.modules, "zstandard", None)
    path = str(tmp_path / "x.dat.zst")
    with open(path, "wb") as f:
        f.write(b"\x28\xb5\x2f\xfd" + b"\x00" * 64)
    with pytest.raises(ImportError) as want:
        _jax(path, **fixed_read_options())
    with pytest.raises(ImportError) as got:
        _port(path, **fixed_read_options())
    # the same error, retried under the same default policy: its message
    # names the attempts and their seconds, then the JAX package's hint
    assert "zstandard" in str(got.value)
    assert re.sub(r"over [0-9.]+s", "", str(got.value)) == \
        re.sub(r"over [0-9.]+s", "", str(want.value))


def test_zstd_feed_parity_where_the_module_imports(fixed_pair, tmp_path):
    pytest.importorskip("zstandard")
    raw, _gz = fixed_pair
    path = str(tmp_path / "txn.dat.zst")
    write_fixed_corpus(path, RECORDS, seed=11, chunk_records=CHUNK_RECORDS,
                       compression="zstd")
    opts = dict(fixed_read_options(), pipeline_workers="2",
                chunk_size_mb="0.1", cache_dir=str(tmp_path / "c"),
                compress_block_mb="0.25")
    _parity(raw, path, opts, raw_opts=fixed_read_options())


# -- the card's default device ---------------------------------------------


def test_compressed_reads_default_to_the_card(fixed_pair):
    """No part of the slice reads quietly on the CPU: a compressed read
    on the default device runs the card path, and raises without one."""
    _raw, gz = fixed_pair
    if torch.cuda.is_available():
        assert len(cobrix_tpu_torch.read_cobol(
            gz, **fixed_read_options())) == RECORDS
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cobrix_tpu_torch.read_cobol(gz, **fixed_read_options())


def test_several_compressed_files_in_a_directory(tmp_path):
    """Files of several codecs in one directory read in listing order,
    with each file's record-id base, as the JAX package reads them."""
    d = tmp_path / "feeds"
    d.mkdir()
    data = pgen.generate_exp2(400, seed=3)
    (d / "a.dat.gz").write_bytes(gzip.compress(data))
    (d / "b.dat.bz2").write_bytes(bz2.compress(data))
    (d / "c.dat.xz").write_bytes(lzma.compress(data))
    opts = dict(copybook_contents=pgen.EXP2_COPYBOOK,
                is_record_sequence="true", segment_field="SEGMENT-ID",
                generate_record_id="true", segment_id_prefix="M",
                **{"redefine-segment-id-map:0": "STATIC-DETAILS => C",
                   "redefine-segment-id-map:1": "CONTACTS => P"})
    got = _port(str(d), **opts).to_arrow()
    _table_eq(_jax(str(d), **opts).to_arrow(), got)
    assert got.num_rows == 1200
