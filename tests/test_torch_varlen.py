"""RDW variable-length and multisegment reads: the port against the JAX
package.

Files are written from ``generate_exp2`` / ``generate_exp3`` with a seed
(re-framed where a case needs other headers, offsets or a cut), and the
same option dict goes to ``cobrix_tpu.read_cobol(..., backend=...)`` for
the "numpy" and "jax" backends and to ``cobrix_tpu_torch.read_cobol(...,
device="cpu")``. Rows and dicts must be equal, types included (the row
trees are compared with each value's type). `segment_id_prefix` is always
given: its default is a timestamp. Malformed headers must raise the same
FramingError; the options this slice does not take must raise ValueError
naming them.
"""
import os

import pytest
import torch

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.reader import parameters as jax_parameters
from cobrix_tpu.reader import var_len_reader as jax_vlr
from cobrix_tpu.reader.diagnostics import FramingError as JaxFramingError
from cobrix_tpu.testing import generators as gen
from cobrix_tpu_torch.reader import var_len_reader as port_vlr
from cobrix_tpu_torch.reader.diagnostics import FramingError

REDEFINES = {"redefine-segment-id-map:0": "STATIC-DETAILS => C",
             "redefine-segment-id-map:1": "CONTACTS => P"}
LEVELS = {"segment_id_level0": "C", "segment_id_level1": "P"}
RDW = {"is_record_sequence": "true", "segment_id_prefix": "PFX"}
SEGMENTS = {"segment_field": "SEGMENT-ID"}


def _records(data: bytes, big_endian: bool = False):
    """(header length, payload) of each record of a generated file."""
    pos, out = 0, []
    while pos + 4 <= len(data):
        h = data[pos:pos + 4]
        ln = (h[0] << 8 | h[1]) if big_endian else (h[3] << 8 | h[2])
        out.append(data[pos + 4:pos + 4 + ln])
        pos += 4 + ln
    return out


def _header(length: int, big_endian: bool = False) -> bytes:
    if big_endian:
        return bytes([length >> 8, length & 0xFF, 0, 0])
    return bytes([0, 0, length & 0xFF, length >> 8])


def _reframe(payloads, stored_delta=0, prefix=b"",
             big_endian=False) -> bytes:
    return b"".join(_header(len(prefix + p) + stored_delta, big_endian)
                    + prefix + p for p in payloads)


def _cut_last_c(data: bytes, keep: int) -> bytes:
    """The file cut `keep` payload bytes into its last 'C' record."""
    pos, last_c = 0, None
    for p in _records(data):
        if p[:1] == b"\xc3":  # EBCDIC 'C'
            last_c = pos
        pos += 4 + len(p)
    return data[:last_c + 4 + keep]


def _files(tmp):
    e2 = gen.generate_exp2(400, seed=21)
    e2_be = gen.generate_exp2(400, seed=22, big_endian_rdw=True)
    e3 = gen.generate_exp3(24, seed=23)
    files = {
        "exp2": e2,
        "exp2_be": e2_be,
        "exp2_be_part_of_length": _reframe(_records(e2_be, True),
                                           stored_delta=4, big_endian=True),
        "exp3": e3,
        "exp2_part_of_length": _reframe(_records(e2), stored_delta=4),
        "exp2_adjusted": _reframe(_records(e2), stored_delta=2),
        "exp2_header_footer": b"\x07" * 20 + e2 + b"\x00" * 13,
        "exp2_record_prefix": _reframe(_records(e2), prefix=b"\x01\x02"
                                       b"\x03\x04\x05"),
        "exp2_cut_in_string": _cut_last_c(e2, 40),
        # records of no Seg_Id level ('X') before the first company, and
        # contacts among them: the levels drop the first two
        "exp2_orphans_first": _reframe(
            [b"\xe7" + r[1:] for r in _records(e2)[1:3]]
            + [r for r in _records(e2) if r[:1] == b"\xd7"][:2]
            + _records(e2)),
        "exp3_cut_in_detail": _cut_last_c(e3, 999),
    }
    paths = {}
    for name, data in files.items():
        paths[name] = os.path.join(tmp, f"{name}.dat")
        with open(paths[name], "wb") as f:
            f.write(data)
    two = os.path.join(tmp, "two")
    os.makedirs(two)
    for k, seed in enumerate((31, 32)):
        with open(os.path.join(two, f"part{k}.dat"), "wb") as f:
            f.write(gen.generate_exp2(150 + 50 * k, seed=seed))
    paths["two_files"] = two
    return paths


CASES = {
    "plain": ("exp2", gen.EXP2_COPYBOOK, {}),
    "segment_field_only": ("exp2", gen.EXP2_COPYBOOK, SEGMENTS),
    "big_endian_levels_redefines_ids": (
        "exp2_be", gen.EXP2_COPYBOOK,
        dict(is_rdw_big_endian="true", generate_record_id=True, **SEGMENTS,
             **LEVELS, **REDEFINES)),
    "rdw_part_of_record_length": (
        "exp2_part_of_length", gen.EXP2_COPYBOOK,
        dict(is_rdw_part_of_record_length="true", **SEGMENTS, **REDEFINES)),
    "big_endian_part_of_record_length": (
        "exp2_be_part_of_length", gen.EXP2_COPYBOOK,
        dict(is_rdw_big_endian="true", is_rdw_part_of_record_length="true",
             **SEGMENTS, **LEVELS, **REDEFINES)),
    "rdw_adjustment": ("exp2_adjusted", gen.EXP2_COPYBOOK,
                       dict(rdw_adjustment="-2", **SEGMENTS, **LEVELS)),
    "file_offsets": (
        "exp2_header_footer", gen.EXP2_COPYBOOK,
        dict(file_start_offset="20", file_end_offset="13",
             generate_record_id="true", **SEGMENTS, **LEVELS, **REDEFINES)),
    "record_start_offset": ("exp2_record_prefix", gen.EXP2_COPYBOOK,
                            dict(record_start_offset=5, **SEGMENTS,
                                 **REDEFINES)),
    "filter_without_levels": ("exp2", gen.EXP2_COPYBOOK,
                              dict(segment_filter="P", **SEGMENTS,
                                   **REDEFINES)),
    "root_and_underscore_spellings": (
        "exp2", gen.EXP2_COPYBOOK,
        {"segment_id_root": "C", "segment_id_level1": "P",
         "redefine_segment_id_map:0": "STATIC-DETAILS => C",
         "is_xcom": "true", **SEGMENTS}),
    "collapse_root_filter": (
        "exp2", gen.EXP2_COPYBOOK,
        dict(schema_retention_policy="collapse_root", segment_filter="C,P",
             **SEGMENTS, **REDEFINES)),
    "exp3_levels_redefines_ids": (
        "exp3", gen.EXP3_COPYBOOK,
        dict(generate_record_id=True, **SEGMENTS, **LEVELS, **REDEFINES)),
    "orphans_before_the_first_root": (
        "exp2_orphans_first", gen.EXP2_COPYBOOK,
        dict(generate_record_id=True, **SEGMENTS, **LEVELS, **REDEFINES)),
    "truncated_in_string": ("exp2_cut_in_string", gen.EXP2_COPYBOOK,
                            dict(**SEGMENTS, **REDEFINES)),
    "exp3_truncated_in_detail": (
        "exp3_cut_in_detail", gen.EXP3_COPYBOOK,
        dict(generate_record_id=True, **SEGMENTS, **REDEFINES)),
    "two_files": ("two_files", gen.EXP2_COPYBOOK,
                  dict(generate_record_id=True, **SEGMENTS, **LEVELS,
                       **REDEFINES)),
}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return _files(str(tmp_path_factory.mktemp("varlen")))


def _typed(v):
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_typed(x) for x in v])
    return (type(v).__name__, v)


def _read_both(path, copybook, options, backend):
    opts = dict(RDW, **options)
    want = cobrix_tpu.read_cobol(path, copybook_contents=copybook,
                                 backend=backend, **opts)
    got = cobrix_tpu_torch.read_cobol(path, copybook_contents=copybook,
                                      device="cpu", **opts)
    return want, got


@pytest.mark.parametrize("backend", ["numpy", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_and_dicts_equal_the_jax_package(case, backend, paths):
    name, copybook, options = CASES[case]
    want, got = _read_both(paths[name], copybook, options, backend)
    assert len(got) == len(want) > 0
    assert got.schema.field_names() == want.schema.field_names()
    assert _typed(got.to_rows()) == _typed(want.to_rows())
    assert _typed(got.to_dicts()) == _typed(want.to_dicts())


@pytest.mark.parametrize("case", ["big_endian_levels_redefines_ids",
                                  "file_offsets", "exp3_levels_redefines_ids",
                                  "exp3_truncated_in_detail", "two_files"])
def test_small_windows_and_batches(case, paths, monkeypatch):
    """Records straddle window cuts (exp3's 16 KB records are longer than
    a window) and segments split into several pack batches."""
    monkeypatch.setattr(port_vlr, "READ_WINDOW_BYTES", 700)
    monkeypatch.setattr(port_vlr, "PACK_BATCH_BYTES", 3000)
    name, copybook, options = CASES[case]
    want, got = _read_both(paths[name], copybook, options, "numpy")
    assert _typed(got.to_rows()) == _typed(want.to_rows())


@pytest.mark.parametrize("options", [
    dict(file_start_offset="20", file_end_offset="13",
         generate_record_id="true", **SEGMENTS, **LEVELS, **REDEFINES),
    dict(file_start_offset="20", file_end_offset="13",
         generate_record_id="true", **SEGMENTS, **REDEFINES),
    dict(file_start_offset="20", file_end_offset="13",
         generate_record_id="true")],
    ids=["root_aligned", "any_record", "no_segments"])
def test_record_ids_follow_the_jax_sparse_index(options, tmp_path,
                                                monkeypatch):
    """Over 100 index MB the JAX package reads a file in shards, and a
    file header then counts as one record from the first split on; the
    megabyte is shrunk so that a small file splits."""
    for module in (jax_parameters, jax_vlr, port_vlr):
        monkeypatch.setattr(module, "MEGABYTE", 100)
    path = tmp_path / "big.dat"
    path.write_bytes(b"\x07" * 20 + gen.generate_exp2(600, seed=41)
                     + b"\x00" * 13)
    want, got = _read_both(str(path), gen.EXP2_COPYBOOK, options, "numpy")
    rows = got.to_rows()
    assert _typed(rows) == _typed(want.to_rows())
    ids = [r[1] for r in rows]
    assert ids[-1] - ids[0] == len(ids) and ids[0] == 0  # one +1 step


def _malformed(tmp, kind):
    data = bytearray(gen.generate_exp2(120, seed=51))
    if kind == "zero":
        pos = sum(4 + len(p) for p in _records(bytes(data))[:37])
        data[pos:pos + 4] = b"\x00\x00\x00\x00"
    path = os.path.join(tmp, f"{kind}.dat")
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


@pytest.mark.parametrize("kind,extra", [
    ("zero", {}), ("big", {"rdw_adjustment": str(100 * 1024 * 1024)})])
@pytest.mark.parametrize("window", [None, 500])
def test_malformed_headers_raise_the_same_error(kind, extra, window,
                                                tmp_path, monkeypatch):
    if window:
        monkeypatch.setattr(port_vlr, "READ_WINDOW_BYTES", window)
    path = _malformed(str(tmp_path), kind)
    opts = dict(RDW, **SEGMENTS, **REDEFINES, **extra)
    with pytest.raises(JaxFramingError) as want:
        cobrix_tpu.read_cobol(path, copybook_contents=gen.EXP2_COPYBOOK,
                              **opts)
    with pytest.raises(FramingError) as got:
        cobrix_tpu_torch.read_cobol(path, copybook_contents=gen.EXP2_COPYBOOK,
                                    device="cpu", **opts)
    w, g = want.value, got.value
    assert (str(g), g.offset, g.reason, g.header) == \
        (str(w), w.offset, w.reason, w.header)
    assert isinstance(g, ValueError) and type(g).__name__ == type(w).__name__


@pytest.mark.parametrize("option,value", [
    ("use_stats", "true"),
    ("collect_stats", "true"),
    ("hosts", "2"),
    ("heartbeat_interval_s", "1"),
    ("progress_interval_s", "1"),
    ("filter", "COMPANY_ID == 'x'"),
])
def test_options_this_slice_does_not_take_are_refused(option, value,
                                                      paths):
    if option == "progress_interval_s":
        # taken since the observability slice: the read equals the JAX
        # package's, and so do the final progress snapshots' counts
        opts = dict(RDW, **SEGMENTS, **{option: value})
        seen = {"port": [], "jax": []}
        got = cobrix_tpu_torch.read_cobol(
            paths["exp2"], copybook_contents=gen.EXP2_COPYBOOK,
            device="cpu", progress_callback=seen["port"].append, **opts)
        want = cobrix_tpu.read_cobol(
            paths["exp2"], copybook_contents=gen.EXP2_COPYBOOK,
            backend="numpy", progress_callback=seen["jax"].append, **opts)
        assert got.to_arrow().equals(want.to_arrow())
        last = {k: v[-1] for k, v in seen.items()}
        assert last["port"].done and last["jax"].done
        assert (last["port"].bytes_total, last["port"].bytes_done,
                last["port"].records_done) == \
            (last["jax"].bytes_total, last["jax"].bytes_done,
             last["jax"].records_done)
        return
    if option == "filter":
        # taken since the filter slice: the filtered read equals the JAX
        # package's, and no record has that company id
        opts = dict(RDW, **SEGMENTS, **{option: value})
        got = cobrix_tpu_torch.read_cobol(
            paths["exp2"], copybook_contents=gen.EXP2_COPYBOOK,
            device="cpu", **opts)
        want = cobrix_tpu.read_cobol(
            paths["exp2"], copybook_contents=gen.EXP2_COPYBOOK,
            backend="numpy", **opts)
        assert len(got) == len(want) == 0
        assert got.to_arrow().equals(want.to_arrow())
        assert got.metrics.pushdown == want.metrics.pushdown
        return
    with pytest.raises(ValueError, match=option):
        cobrix_tpu_torch.read_cobol(
            paths["exp2"], copybook_contents=gen.EXP2_COPYBOOK, device="cpu",
            **dict(RDW, **SEGMENTS, **{option: value}))


@pytest.mark.parametrize("option", ["segment_field", "rdw_adjustment",
                                    "generate_record_id",
                                    "redefine-segment-id-map:0"])
def test_rdw_options_need_an_rdw_file(option, tmp_path):
    """The options that RDW reads took first are taken on fixed-length
    files too, as the JAX package takes them: the same rows, or the same
    error."""
    path = tmp_path / "fixed.dat"
    path.write_bytes(gen.generate_exp1(2, seed=1).tobytes())
    opts = {"copybook_contents": gen.EXP1_COPYBOOK,
            option: "SEGMENT-ID => C" if ":" in option else "1"}
    try:
        want = cobrix_tpu.read_cobol(str(path), backend="numpy",
                                     **opts).to_rows()
    except Exception as exc:  # the JAX package's error, to match
        with pytest.raises(type(exc)) as got:
            cobrix_tpu_torch.read_cobol(str(path), device="cpu",
                                        **opts).to_rows()
        assert str(got.value) == str(exc)
        return
    got = cobrix_tpu_torch.read_cobol(str(path), device="cpu", **opts)
    assert got.to_rows() == want


def test_rdw_read_defaults_to_cuda(paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is used")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cobrix_tpu_torch.read_cobol(
            paths["exp2"], copybook_contents=gen.EXP2_COPYBOOK, **RDW)


def test_framing_keeps_the_kernels_path_on_cpu_tensors(paths, monkeypatch):
    """On the CPU both framing wrappers take their plain versions and
    count no launch."""
    from cobrix_tpu_torch.ops import device_framing as df

    monkeypatch.setattr(df.scan_window, "launches", 0)
    monkeypatch.setattr(df.pack_records, "launches", 0)
    name, copybook, options = CASES["exp3_levels_redefines_ids"]
    cobrix_tpu_torch.read_cobol(paths[name], copybook_contents=copybook,
                                device="cpu", **dict(RDW, **options))
    assert df.scan_window.launches == 0 and df.pack_records.launches == 0


def test_segment_levels_match_the_accumulator(paths):
    """The vectorized Seg_Id levels equal the per-record accumulator."""
    from cobrix_tpu.reader.var_len_reader import SegmentIdAccumulator
    from cobrix_tpu_torch.reader.var_len_reader import \
        _segment_level_ids_vectorized

    ids = ["C", "P", "P", "X", "C", "P", "C", "P", "P", "P"]
    levels, no_match = _segment_level_ids_vectorized(
        ["Z"] + ids, ["C", "P"], "PFX", 3, 100)
    acc = SegmentIdAccumulator(["C", "P"], "PFX", 3)
    for i, sid in enumerate(["Z"] + ids):
        acc.acquired_segment_id(sid, 100 + i)
        assert levels[i] == [acc.get_segment_level_id(k) for k in (0, 1)]
    assert no_match.tolist() == [True] + [False] * len(ids)
