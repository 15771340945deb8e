"""The statistics plane of the port against the JAX package, on the CPU.

The same bytes, made with numpy from the port's generators, go through
``cobrix_tpu`` (numpy backend, one thread) and ``cobrix_tpu_torch``
(``device="cpu"``) with ``collect_stats`` and ``use_stats``. The
persisted profiles must be equal payload for payload (``to_payload``),
whichever execution mode collected them; every ``use_stats`` read must
equal the JAX package's stats-off filtered read (``Table.equals``); a
stats-answered aggregate must equal the JAX package's answer and the
port's decode path, types included. A corrupt, stale, foreign or
differently configured profile is a miss and never a skip. A stats-off
read never touches the stats package.

C10 (ROADMAP.md): a sequential RDW read whose every shard the profile
skips raises in the JAX package (``max_workers must be greater than
0``); the port returns the stats-off read's empty table.
"""
import json
import os
import subprocess
import sys

import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.query import dataset as jax_dataset
from cobrix_tpu.stats import drift as jax_drift
from cobrix_tpu_torch.io.integrity import corruption_counter
from cobrix_tpu_torch.query import dataset
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.stats import collect, drift, service
from cobrix_tpu_torch.stats.aggregate import parse_specs
from cobrix_tpu_torch.testing import generators as gen
from cobrix_tpu_torch.testing.faults import (cache_entry_paths,
                                             corrupt_cache_entry)

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SORTED_COPYBOOK = """
       01  REC.
           05  KEY-ID    PIC 9(4).
           05  NAME      PIC X(4).
"""
SORTED = dict(copybook_contents=SORTED_COPYBOOK)
GRID = dict(stats_chunk_mb="0.002")
VRL = dict(copybook_contents=gen.EXP2_COPYBOOK,
           is_record_sequence="true", segment_field="SEGMENT_ID",
           schema_retention_policy="collapse_root",
           redefine_segment_id_map="STATIC-DETAILS => C",
           input_split_records="200",
           **{"redefine-segment-id-map:1": "CONTACTS => P"})
FIXED = dict(copybook_contents=gen.TRANSDATA_COPYBOOK,
             schema_retention_policy="collapse_root")
PIPELINED_FIXED = {"pipeline_workers": "2", "chunk_size_mb": "0.008"}
FIXED_FILTERS = ["KEY_ID == 5", "KEY_ID >= 4000", "KEY_ID == 9999",
                 "NAME == 'ZZZZ'", "KEY_ID < 300 and NAME == 'AAAA'"]
VRL_FILTERS = ["COMPANY_ID == '00'",
               "SEGMENT_ID == 'C' and COMPANY_ID < '3'",
               "SEGMENT_ID == 'P'"]
STREAM_COPYBOOK = """
        01  R.
            05  KEY    PIC 9(7) COMP.
            05  NAME   PIC X(9).
"""


def _sorted_fixed_bytes(n=4096):
    """n 8-byte EBCDIC records with KEY-ID == record ordinal, so chunk
    zone maps are disjoint and equality filters are ~1-chunk
    selective."""
    import numpy as np

    digits = np.array([[int(d) for d in f"{i:04d}"] for i in range(n)],
                      dtype=np.uint8) + 0xF0
    names = np.repeat(np.where(np.arange(n) % 2 == 0, 0xC1, 0xC2)
                      .astype(np.uint8)[:, None], 4, axis=1)
    return np.concatenate([digits, names], axis=1).tobytes()


def _port(path, **opts):
    return cobrix_tpu_torch.read_cobol(path, device="cpu", **opts)


def _jax(path, **opts):
    return cobrix_tpu.read_cobol(path, backend="numpy", parallelism="1",
                                 **opts)


def _profiles(cache_dir):
    """{url: profile payload} of every stats entry under `cache_dir`."""
    out = {}
    for path in cache_entry_paths(cache_dir, "stats"):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)["profile"]
        out[doc["url"]] = doc
    return out


@pytest.fixture(scope="module")
def sorted_fixed(tmp_path_factory):
    path = tmp_path_factory.mktemp("sorted") / "sorted.dat"
    path.write_bytes(_sorted_fixed_bytes())
    return str(path)


@pytest.fixture(scope="module")
def vrl_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vrl") / "companies.dat"
    path.write_bytes(bytes(gen.generate_exp2(1200, seed=7)))
    return str(path)


@pytest.fixture(scope="module")
def sorted_cache(sorted_fixed, tmp_path_factory):
    """A cache_dir holding the port's profile of `sorted_fixed` (the
    tests that only read it share it)."""
    cache = str(tmp_path_factory.mktemp("sorted_cache"))
    _port(sorted_fixed, cache_dir=cache, collect_stats="true", **GRID,
          **SORTED)
    return cache


@pytest.fixture(scope="module")
def vrl_cache(vrl_file, tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("vrl_cache"))
    _port(vrl_file, cache_dir=cache, collect_stats="true", **VRL)
    return cache


# -- zero overhead when off ----------------------------------------------

def test_stats_off_reads_pay_zero_overhead(sorted_fixed, tmp_path):
    before = collect.overhead_events()
    d = _port(sorted_fixed, filter="KEY_ID == 5",
              cache_dir=str(tmp_path / "cache"), **SORTED)
    assert d.to_arrow().num_rows == 1
    assert collect.overhead_events() == before
    pd = d.metrics.pushdown
    assert pd["chunks_considered"] == 0 and pd["chunks_skipped"] == 0
    assert d.stats_profiles is None
    # a fresh process: a stats-off read, sequential and pipelined,
    # never imports the stats package
    code = (
        "import sys, cobrix_tpu_torch as t\n"
        f"for extra in ({{}}, {PIPELINED_FIXED!r}):\n"
        f"    d = t.read_cobol({sorted_fixed!r}, device='cpu',\n"
        f"        copybook_contents={SORTED_COPYBOOK!r},\n"
        "        filter='KEY_ID == 5', **extra)\n"
        "    assert len(d.to_arrow()) == 1\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('cobrix_tpu_torch.stats')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- profiles: equal across modes and to the JAX package's ---------------

@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_fixed_profile_equals_the_jax_package(sorted_fixed, sorted_cache,
                                              tmp_path, mode):
    jax_cache = str(tmp_path / "jax")
    _jax(sorted_fixed, cache_dir=jax_cache, collect_stats="true", **GRID,
         **SORTED)
    want = _profiles(jax_cache)
    assert list(want) == [sorted_fixed]
    assert len(want[sorted_fixed]["chunks"]) == 16
    extra = PIPELINED_FIXED if mode == "pipelined" else {}
    cache = str(tmp_path / "port")
    d = _port(sorted_fixed, cache_dir=cache, collect_stats="true",
              **GRID, **SORTED, **extra)
    assert _profiles(cache) == want == _profiles(sorted_cache)
    assert d.stats_profiles[sorted_fixed]["records"] == 4096
    assert d.metrics.timings_s["collect_stats"] > 0


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_vrl_profile_equals_the_jax_package(vrl_file, vrl_cache, tmp_path,
                                            mode):
    jax_cache = str(tmp_path / "jax")
    _jax(vrl_file, cache_dir=jax_cache, collect_stats="true", **VRL)
    want = _profiles(jax_cache)
    assert want[vrl_file]["record_kind"] == "vrl"
    extra = {"pipeline_workers": "2"} if mode == "pipelined" else {}
    cache = str(tmp_path / "port")
    _port(vrl_file, cache_dir=cache, collect_stats="true", **VRL, **extra)
    assert _profiles(cache) == want == _profiles(vrl_cache)


# -- chunk skipping ------------------------------------------------------

@pytest.mark.parametrize("flt", FIXED_FILTERS)
@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_fixed_skipping_parity(sorted_fixed, sorted_cache, flt, mode):
    extra = PIPELINED_FIXED if mode == "pipelined" else {}
    want = _jax(sorted_fixed, filter=flt, **SORTED).to_arrow()
    warm = _port(sorted_fixed, cache_dir=sorted_cache, use_stats="true",
                 filter=flt, **GRID, **SORTED, **extra)
    assert warm.to_arrow().equals(want)
    pd = warm.metrics.pushdown
    assert pd["chunks_considered"] > 0
    if flt == "KEY_ID == 5":
        # a 1-chunk-selective filter: >= 90% of the chunks never read
        assert pd["chunks_skipped"] / pd["chunks_considered"] >= 0.9, pd
        assert pd["bytes_skipped"] > 0


def test_fixed_skip_counters_equal_the_jax_package(sorted_fixed,
                                                   tmp_path):
    """Where the JAX package's warm read works, its chunk counters are
    the port's: the same grid, the same proofs."""
    jax_cache = str(tmp_path / "jax")
    _jax(sorted_fixed, cache_dir=jax_cache, collect_stats="true", **GRID,
         **SORTED)
    cache = str(tmp_path / "port")
    _port(sorted_fixed, cache_dir=cache, collect_stats="true", **GRID,
          **SORTED)
    for flt in FIXED_FILTERS:
        want = _jax(sorted_fixed, cache_dir=jax_cache, use_stats="true",
                    filter=flt, **GRID, **SORTED).metrics.pushdown
        got = _port(sorted_fixed, cache_dir=cache, use_stats="true",
                    filter=flt, **GRID, **SORTED).metrics.pushdown
        assert got == want, flt


@pytest.mark.parametrize("flt", VRL_FILTERS)
@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_vrl_multisegment_skipping_parity(vrl_file, vrl_cache, flt, mode):
    extra = {"pipeline_workers": "2"} if mode == "pipelined" else {}
    want = _jax(vrl_file, filter=flt, **VRL).to_arrow()
    warm = _port(vrl_file, cache_dir=vrl_cache, use_stats="true",
                 filter=flt, **VRL, **extra)
    assert warm.to_arrow().equals(want), flt
    pd = warm.metrics.pushdown
    assert pd["chunks_considered"] == 6
    if flt == "COMPANY_ID == '00'":
        # provably below the file-wide min: everything skips
        assert pd["chunks_skipped"] == pd["chunks_considered"]
        assert len(warm) == 0 and not warm.parts
    if flt == "SEGMENT_ID == 'P'":
        # every shard holds contacts: nothing skipped, every shard read
        assert pd["chunks_skipped"] == 0


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_generic_framing_skipping_parity(sorted_fixed, tmp_path, mode):
    """The sorted records through the generic per-record reader
    (`variable_size_occurs`) in index shards of 500: the kept shards
    are read as the stats-off read reads them."""
    opts = dict(SORTED, variable_size_occurs="true",
                input_split_records="500")
    extra = {"pipeline_workers": "2"} if mode == "pipelined" else {}
    cache = str(tmp_path / "cache")
    _port(sorted_fixed, cache_dir=cache, collect_stats="true", **opts)
    for flt, skipped in (("KEY_ID == 5", 8), ("KEY_ID >= 4000", 8),
                         ("NAME == 'ZZZZ'", 9)):
        want = _jax(sorted_fixed, filter=flt, **opts).to_arrow()
        warm = _port(sorted_fixed, cache_dir=cache, use_stats="true",
                     filter=flt, **opts, **extra)
        assert warm.to_arrow().equals(want), flt
        pd = warm.metrics.pushdown
        assert (pd["chunks_considered"], pd["chunks_skipped"]) == \
            (9, skipped), flt


@pytest.mark.parametrize("kind", ["fixed", "vrl"])
def test_empty_plan_pipelines_end_clean(sorted_fixed, sorted_cache,
                                        vrl_file, vrl_cache, kind):
    """Every chunk skipped on a pipelined read: no part, the stats-off
    read's empty table, and no stage thread left behind."""
    import threading

    path, cache, flt, opts = (
        (sorted_fixed, sorted_cache, "KEY_ID == 9999",
         dict(SORTED, **GRID, **PIPELINED_FIXED)) if kind == "fixed" else
        (vrl_file, vrl_cache, "COMPANY_ID == '00'",
         dict(VRL, pipeline_workers="2")))
    warm = _port(path, cache_dir=cache, use_stats="true", filter=flt,
                 **opts)
    assert not warm.parts and len(warm) == 0
    assert warm.metrics.pipeline["chunks"] == 0
    base = {k: v for k, v in opts.items()
            if k not in ("pipeline_workers", "chunk_size_mb",
                         "stats_chunk_mb")}
    assert warm.to_arrow().equals(_jax(path, filter=flt, **base).to_arrow())
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("cobrix-pipe")]


def test_c10_every_shard_skipped_sequential(vrl_file, vrl_cache, tmp_path):
    """C10: the JAX package's sequential warm read of an RDW file whose
    every shard the profile skips raises; the port's returns the
    stats-off filtered read's 0-row table."""
    flt = "COMPANY_ID == '00'"
    jax_cache = str(tmp_path / "jax")
    _jax(vrl_file, cache_dir=jax_cache, collect_stats="true", **VRL)
    with pytest.raises(ValueError, match="max_workers"):
        # the shard pool of its indexed scan (any parallelism above 1;
        # its default is min(16, cpu_count)) is sized by the 0 kept
        # shards
        cobrix_tpu.read_cobol(vrl_file, backend="numpy", parallelism="4",
                              cache_dir=jax_cache, use_stats="true",
                              filter=flt, **VRL)
    want = _jax(vrl_file, filter=flt, **VRL).to_arrow()
    got = _port(vrl_file, cache_dir=vrl_cache, use_stats="true",
                filter=flt, **VRL).to_arrow()
    assert want.num_rows == 0
    assert got.equals(want)
    assert got.schema.equals(want.schema, check_metadata=True)


def test_compressed_fixed_profile_is_of_decompressed_records(tmp_path):
    """A gzip fixed-length file is profiled on its decompressed records,
    the offsets every read of it skips on: with 1-byte records any
    compressed size is a whole number of records, and a profile of the
    compressed bytes would prove the first chunks empty."""
    import gzip

    import numpy as np

    copybook = "       01  R.\n           05  D  PIC 9(1).\n"
    raw = (np.repeat(np.arange(10, dtype=np.uint8), 200) + 0xF0).tobytes()
    path = str(tmp_path / "digits.dat.gz")
    with open(path, "wb") as f:
        f.write(gzip.compress(raw, mtime=0))
    opts = dict(copybook_contents=copybook, stats_chunk_mb="0.00005")
    cache = str(tmp_path / "cache")
    d = _port(path, cache_dir=cache, collect_stats="true", **opts)
    assert d.stats_profiles[path]["records"] == len(raw)
    for flt in ("D == 0", "D == 9", "D == 5"):
        want = _jax(path, filter=flt, copybook_contents=copybook).to_arrow()
        off = _port(path, cache_dir=cache, filter=flt, **opts).to_arrow()
        warm = _port(path, cache_dir=cache, use_stats="true", filter=flt,
                     **opts)
        assert want.num_rows == 200
        assert warm.to_arrow().equals(off) and off.equals(want), flt
        pd = warm.metrics.pushdown
        assert pd["chunks_skipped"] > 0.8 * pd["chunks_considered"], pd


def test_profile_survives_grid_mismatch(sorted_fixed, sorted_cache):
    """The split grid is deliberately OUTSIDE the config fingerprint: a
    profile collected on one grid serves scans planned on any other."""
    want = _jax(sorted_fixed, filter="KEY_ID == 9999", **SORTED)
    warm = _port(sorted_fixed, cache_dir=sorted_cache, use_stats="true",
                 stats_chunk_mb="0.008",  # 4x the profile grid
                 filter="KEY_ID == 9999", **SORTED)
    assert warm.to_arrow().equals(want.to_arrow())
    pd = warm.metrics.pushdown
    assert pd["chunks_skipped"] == pd["chunks_considered"] == 4


# -- corruption, configuration and version misses ------------------------

@pytest.mark.parametrize("mode", ["bitflip", "garbage", "truncate"])
def test_corrupt_stats_entry_quarantines_and_falls_back(
        sorted_fixed, tmp_path, mode):
    cache = str(tmp_path / "cache")
    opts = dict(cache_dir=cache, **GRID, **SORTED)
    _port(sorted_fixed, collect_stats="true", **opts)
    corrupt_cache_entry(cache, "stats", mode=mode)
    before = corruption_counter().value(plane="stats")
    want = _jax(sorted_fixed, filter="KEY_ID == 5", **SORTED).to_arrow()
    warm = _port(sorted_fixed, use_stats="true", filter="KEY_ID == 5",
                 **opts)
    # full-scan fallback: equal table, nothing skipped
    assert warm.to_arrow().equals(want)
    assert warm.metrics.pushdown["chunks_skipped"] == 0
    assert corruption_counter().value(plane="stats") == before + 1
    assert not cache_entry_paths(cache, "stats")  # quarantined away
    assert os.listdir(os.path.join(cache, "quarantine"))
    # the next collecting read rebuilds, and skipping resumes
    _port(sorted_fixed, collect_stats="true", **opts)
    again = _port(sorted_fixed, use_stats="true", filter="KEY_ID == 5",
                  **opts)
    assert again.to_arrow().equals(want)
    assert again.metrics.pushdown["chunks_skipped"] > 0


def test_wrong_config_profile_is_a_clean_miss(sorted_fixed, sorted_cache):
    # record_error_policy is part of the decode configuration: the
    # warm profile must NOT serve a differently-configured scan
    opts = dict(record_error_policy="permissive", filter="KEY_ID == 5",
                **SORTED)
    want = _jax(sorted_fixed, **opts).to_arrow()
    warm = _port(sorted_fixed, cache_dir=sorted_cache, use_stats="true",
                 **GRID, **opts)
    assert warm.to_arrow().equals(want)
    assert warm.metrics.pushdown["chunks_skipped"] == 0


def test_stale_file_version_is_a_clean_miss(tmp_path):
    path = tmp_path / "sorted.dat"
    path.write_bytes(_sorted_fixed_bytes())
    cache = str(tmp_path / "cache")
    _port(str(path), cache_dir=cache, collect_stats="true", **GRID,
          **SORTED)
    # rewrite the file (same decodable content, new version): the old
    # profile must not produce skips against the new bytes
    path.write_bytes(path.read_bytes())
    os.utime(path, ns=(1, 1))
    warm = _port(str(path), cache_dir=cache, use_stats="true",
                 filter="KEY_ID == 5", **GRID, **SORTED)
    assert warm.to_arrow().num_rows == 1
    assert warm.metrics.pushdown["chunks_skipped"] == 0


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_cold_stats_do_not_decide_the_read(sorted_fixed, vrl_file,
                                           tmp_path, mode):
    """No profile collected: a use_stats read scans every chunk and
    equals the stats-off read."""
    cache = str(tmp_path / "cold")
    fixed_extra = PIPELINED_FIXED if mode == "pipelined" else {}
    for path, opts, extra in (
            (sorted_fixed, SORTED, fixed_extra),
            (vrl_file, VRL,
             {"pipeline_workers": "2"} if mode == "pipelined" else {})):
        flt = "COMPANY_ID == '00'" if path == vrl_file else "KEY_ID == 5"
        want = _port(path, filter=flt, **opts, **extra)
        warm = _port(path, cache_dir=cache, use_stats="true", filter=flt,
                     **opts, **extra)
        assert warm.to_arrow().equals(want.to_arrow())
        assert warm.metrics.pushdown == want.metrics.pushdown
        assert not cache_entry_paths(cache, "stats")


def test_foreign_package_profiles_are_misses(sorted_fixed, tmp_path):
    """A cache_dir shared with the JAX package: each package's profile
    is a miss for the other, and neither entry is touched."""
    cache = str(tmp_path / "shared")
    _jax(sorted_fixed, cache_dir=cache, collect_stats="true", **GRID,
         **SORTED)
    [jax_entry] = cache_entry_paths(cache, "stats")
    jax_bytes = open(jax_entry, "rb").read()
    flt = "KEY_ID == 5"
    warm = _port(sorted_fixed, cache_dir=cache, use_stats="true",
                 filter=flt, **GRID, **SORTED)
    assert warm.metrics.pushdown["chunks_skipped"] == 0
    assert warm.to_arrow().equals(
        _jax(sorted_fixed, filter=flt, **SORTED).to_arrow())
    _port(sorted_fixed, cache_dir=cache, collect_stats="true", **GRID,
          **SORTED)
    entries = cache_entry_paths(cache, "stats")
    assert len(entries) == 2 and open(jax_entry, "rb").read() == jax_bytes
    os.remove(jax_entry)
    # the port's entry alone: the JAX package misses, the port skips
    jax_warm = _jax(sorted_fixed, cache_dir=cache, use_stats="true",
                    filter=flt, **GRID, **SORTED)
    assert jax_warm.metrics.pushdown["chunks_skipped"] == 0
    port_warm = _port(sorted_fixed, cache_dir=cache, use_stats="true",
                      filter=flt, **GRID, **SORTED)
    assert port_warm.metrics.pushdown["chunks_skipped"] == 15


def test_stats_options_are_checked_as_in_the_jax_package(sorted_fixed):
    for opts, match in (({"collect_stats": "true"}, "require 'cache_dir'"),
                        ({"use_stats": "true"}, "require 'cache_dir'"),
                        ({"stats_chunk_mb": "0", "cache_dir": "c"},
                         "Invalid 'stats_chunk_mb' of 0.0")):
        with pytest.raises(ValueError, match=match) as want:
            _jax(sorted_fixed, **opts, **SORTED)
        with pytest.raises(ValueError, match=match) as got:
            _port(sorted_fixed, **opts, **SORTED)
        assert str(got.value) == str(want.value)


# -- aggregates ----------------------------------------------------------

def _types(answer):
    return [type(answer[k]) for k in sorted(answer)]


def test_fixed_aggregates_from_stats_match_decode(tmp_path):
    path = tmp_path / "trans.dat"
    path.write_bytes(bytes(gen.generate_transactions(1500, seed=3)))
    path = str(path)
    cache = str(tmp_path / "cache")
    _port(path, cache_dir=cache, collect_stats="true",
          stats_chunk_mb="0.01", **FIXED)
    aggs = ["count", "min:AMOUNT", "max:AMOUNT", "sum:AMOUNT",
            "min:CURRENCY", "max:CURRENCY", "sum:WEALTH_QFY"]
    ds_stats = dataset(path, cache_dir=cache, use_stats="true",
                       device="cpu", **FIXED)
    fast = ds_stats._aggregate_from_stats(parse_specs(aggs))
    assert fast is not None, "stats path did not answer"
    plain = dataset(path, device="cpu", **FIXED).aggregate(aggs)
    want = jax_dataset(path, backend="numpy", **FIXED).aggregate(aggs)
    assert fast == plain == want
    # types too: Decimal stays Decimal, int stays int
    assert _types(fast) == _types(plain) == _types(want)
    assert ds_stats.aggregate(aggs) == want
    assert ds_stats.count_rows() == 1500
    # a filtered aggregate always takes the decode path — and agrees
    filt = ds_stats.aggregate(["count"], filter="WEALTH_QFY == 1")
    assert filt == jax_dataset(path, backend="numpy", **FIXED).aggregate(
        ["count"], filter="WEALTH_QFY == 1")


def test_vrl_multisegment_aggregates_match_decode(vrl_file, vrl_cache):
    opts = {k: v for k, v in VRL.items() if k != "input_split_records"}
    aggs = ["count", "min:COMPANY_ID", "max:COMPANY_ID",
            "min:SEGMENT_ID", "max:SEGMENT_ID"]
    ds_stats = dataset(vrl_file, cache_dir=vrl_cache, use_stats="true",
                       device="cpu", **opts)
    fast = ds_stats._aggregate_from_stats(parse_specs(aggs))
    assert fast is not None, "stats path did not answer"
    plain = dataset(vrl_file, device="cpu", **opts).aggregate(aggs)
    want = jax_dataset(vrl_file, backend="numpy", parallelism="1",
                       **opts).aggregate(aggs)
    assert fast == plain == want
    assert _types(fast) == _types(want)
    assert ds_stats.count_rows() == 1200


def test_cold_aggregate_falls_back_to_decode(tmp_path):
    path = tmp_path / "trans.dat"
    path.write_bytes(bytes(gen.generate_transactions(200, seed=3)))
    ds = dataset(str(path), cache_dir=str(tmp_path / "cache"),
                 use_stats="true", device="cpu", **FIXED)
    # no profile collected: the stats path declines, decode answers
    assert ds._aggregate_from_stats(parse_specs(["count"])) is None
    assert ds.aggregate(["count"]) == {"count": 200}
    assert ds.aggregate(["count", "sum:AMOUNT"]) == jax_dataset(
        str(path), backend="numpy", **FIXED).aggregate(
            ["count", "sum:AMOUNT"])


# -- observability surfaces ----------------------------------------------

def test_explain_reports_statistics_and_skips(sorted_fixed, tmp_path):
    cache = str(tmp_path / "cache")
    rep = _port(sorted_fixed, cache_dir=cache, collect_stats="true",
                explain=True, **GRID, **SORTED)
    doc = rep.as_dict()
    want = cobrix_tpu.read_cobol(
        sorted_fixed, backend="numpy", cache_dir=str(tmp_path / "jax"),
        collect_stats="true", explain=True, **GRID, **SORTED).as_dict()
    assert doc["statistics"] == want["statistics"]
    assert "statistics:" in rep.render()
    rep2 = _port(sorted_fixed, cache_dir=cache, use_stats="true",
                 filter="KEY_ID == 9999", explain=True, **GRID, **SORTED)
    text = rep2.render()
    assert "chunk skipping:" in text
    measured = rep2.as_dict()["pushdown"]["measured"]
    assert measured == rep2.data.metrics.pushdown
    assert measured["chunks_skipped"] == measured["chunks_considered"] \
        == 16


def test_service_snapshot_counts_profiles(sorted_fixed, tmp_path):
    service.reset_for_tests()
    _port(sorted_fixed, cache_dir=str(tmp_path / "cache"),
          collect_stats="true", **GRID, **SORTED)
    snap = service.snapshot()
    assert snap["counts"]["profiles_built"] == 1
    prof = snap["profiles"][sorted_fixed]
    assert prof["records"] == 4096 and prof["chunks"] == 16
    assert prof["fields"]["KEY_ID"] == {"kind": "int", "nulls": 0,
                                        "min": 0, "max": 4095}
    service.note_drift([{"kind": "null_rate", "field": "NAME"}])
    assert service.snapshot()["counts"]["drift_events"] == 1
    service.reset_for_tests()
    assert service.snapshot()["counts"] == {"profiles_built": 0,
                                            "drift_events": 0}


def _stream_table(tmp_path, name, start):
    data = b"".join((start + i).to_bytes(4, "big")
                    + f"ROW{(start + i) % 1000000:06d}".encode("ascii")
                    for i in range(50))
    path = tmp_path / name
    path.write_bytes(data)
    return _port(str(path), copybook_contents=STREAM_COPYBOOK,
                 encoding="ascii").to_arrow(), len(data)


def test_generation_drift_equals_the_jax_package(tmp_path):
    """gen0 keys 0..49, gen1 keys 1000000..1000049: both packages fold
    the same two tables into generation profiles and emit the same
    out_of_range drift record for KEY."""
    tables = [_stream_table(tmp_path, "g0.dat", 0),
              _stream_table(tmp_path, "g1.dat", 1000000)]
    events = {}
    for name, mod in (("port", drift), ("jax", jax_drift)):
        gens = []
        for i, (table, nbytes) in enumerate(tables):
            g = mod.GenerationProfile(f"gen{i}")
            g.fold(table, nbytes)
            gens.append(g)
        assert gens[1].summary() == {"generation": "gen1", "records": 50,
                                     "bytes": 650}
        events[name] = mod.compare_generations(gens[0], gens[1])
        assert mod.compare_generations(gens[0], gens[0]) == []
    assert events["port"] == events["jax"]
    assert [e["kind"] for e in events["port"]] == ["out_of_range"]
    assert events["port"][0]["field"] == "KEY"
