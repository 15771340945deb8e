"""The permissive record error policies of the port against the JAX
package, on the CPU.

The corruption x policy matrix of ``tests/test_fault_tolerance.py`` goes
with the same bytes (``generate_exp2`` and ``generate_exp1`` from fixed
seeds, broken by ``testing/faults.py``) to ``cobrix_tpu.read_cobol``
(numpy backend, one thread) and to ``cobrix_tpu_torch.read_cobol(...,
device="cpu")``, sequential and through the sparse index
(``input_split_records``): the rows, the JSON lines, the Arrow table
(its ``cobrix_tpu.read_diagnostics`` metadata included), the
``_corrupt_record`` column and the ledger's ``as_dict()`` must be equal,
or both reads must raise the same error class with the same message and
offset. The fixed-length torn tail, the option checks and the resync
search itself (`find_next_rdw`, the plain `rdw_scan_permissive`) are
held the same way.
"""
import numpy as np
import pytest

import cobrix_tpu
import cobrix_tpu_torch
from cobrix_tpu.reader import recovery as jax_recovery
from cobrix_tpu.reader.diagnostics import ReadDiagnostics as JaxDiagnostics
from cobrix_tpu.reader.diagnostics import RecordErrorPolicy as JaxPolicy
from cobrix_tpu.testing import generators as gen
from cobrix_tpu_torch.reader import recovery
from cobrix_tpu_torch.reader import var_len_reader as port_vlr
from cobrix_tpu_torch.reader.arrow_out import warm_pyarrow
from cobrix_tpu_torch.reader.diagnostics import (ReadDiagnostics,
                                                 RecordErrorPolicy)
from cobrix_tpu_torch.testing import faults

from util import hard_timeout

# pyarrow's first masked pa.array imports pandas: on this thread, before
# any reader's threads build arrays (ROADMAP C4)
warm_pyarrow()

POLICIES = ["fail_fast", "permissive", "drop_malformed"]
EXP2 = dict(copybook_contents=gen.EXP2_COPYBOOK, is_record_sequence="true",
            segment_field="SEGMENT-ID",
            **{"redefine-segment-id-map:0": "STATIC-DETAILS => C",
               "redefine-segment-id-map:1": "CONTACTS => P"})


@pytest.fixture(autouse=True)
def _no_hang(request):
    with hard_timeout(120, request.node.name):
        yield


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(bytes(data))
    return str(path)


def _outcome(read):
    """Everything a read gives, or its error: class name, message and
    offset."""
    try:
        data = read()
        table = data.to_arrow()
        return ("ok", data.to_rows(), data.to_json_lines(), table,
                data.diagnostics.as_dict() if data.diagnostics else None)
    except Exception as exc:
        return ("error", type(exc).__name__, str(exc),
                getattr(exc, "offset", None))


def _same(path, options, pipelined=False):
    """The port's read (and its pipelined read) equals the JAX package's
    read, or raises its error; returns the port's outcome."""
    want = _outcome(lambda: cobrix_tpu.read_cobol(
        path, backend="numpy", parallelism="1", **options))
    reads = [{}] + ([dict(pipeline_workers="3")] if pipelined else [])
    got = None
    for extra in reads:
        got = _outcome(lambda: cobrix_tpu_torch.read_cobol(
            path, device="cpu", **options, **extra))
        assert got[0] == want[0], (got[:3], want[:3])
        if want[0] == "error":
            assert got[1:] == want[1:]
            continue
        _, rows, lines, table, ledger = got
        assert rows == want[1]
        assert lines == want[2]
        assert table.schema.equals(want[3].schema, check_metadata=True)
        assert table.equals(want[3])
        assert ledger == want[4]
    return got


# -- the RDW corruption x policy matrix ---------------------------------------

def _clean():
    return gen.generate_exp2(300, seed=11)


def _corrupt(kind):
    """(bytes, extra options) of one corruption class."""
    clean = _clean()
    starts = faults.rdw_record_starts(clean)
    if kind == "zero":
        return faults.zero_rdw(clean, starts[40]), {}
    if kind == "oversized":
        return faults.oversize_rdw(clean, starts[120]), {}
    if kind == "splice":
        return faults.splice_garbage(clean, starts[70],
                                     faults.garbage_run(64, seed=3)), {}
    if kind == "truncated":
        return faults.truncate(clean, len(clean) - 9), {}
    if kind == "bit_flip":
        return faults.flip_bit(clean, starts[200] + 2, 5), {}
    if kind == "long_run":
        # zero bytes never parse as a header: a run longer than the
        # window raises under every policy
        return (faults.splice_garbage(clean, starts[10], b"\x00" * 4096),
                {"resync_window": "1024"})
    if kind == "several":
        data = faults.zero_rdw(clean, starts[5])
        data = faults.zero_rdw(data, starts[150])
        data = faults.splice_garbage(data, starts[250],
                                     faults.garbage_run(33, seed=8))
        return faults.truncate(data, len(data) - 3), {}
    raise AssertionError(kind)


KINDS = ["zero", "oversized", "splice", "truncated", "bit_flip",
         "long_run", "several"]


@pytest.mark.parametrize("indexed", [False, True],
                         ids=["sequential", "indexed"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", KINDS)
def test_rdw_corruption_matrix(tmp_path, kind, policy, indexed):
    data, extra = _corrupt(kind)
    options = dict(EXP2, record_error_policy=policy, **extra)
    if policy != "fail_fast":
        options["corrupt_record_column"] = "_corrupt_record"
    if indexed:
        options["input_split_records"] = "50"
    got = _same(_write(tmp_path, f"{kind}.dat", data), options,
                pipelined=indexed)
    if kind == "long_run":
        assert got[0] == "error" and ("resync window" in got[2]) == (
            policy != "fail_fast")
    elif policy == "fail_fast" and kind in ("zero", "several"):
        assert got[0] == "error" and "00 00 00 00" in got[2]


@pytest.mark.parametrize("policy", ["permissive", "drop_malformed"])
def test_resync_rejects_payload_parsed_headers(tmp_path, policy):
    """The regression of ``test_fault_tolerance.py``: a candidate inside
    the zeroed header parses as a long length, and the reserved-pair
    check on its successors must kill it, so the resync lands on the
    next record and skips exactly the corrupt one."""
    big = gen.generate_exp2(4000, seed=9)
    starts = faults.rdw_record_starts(big)
    path = _write(tmp_path, "big_zero.dat", faults.zero_rdw(big,
                                                            starts[1000]))
    got = _same(path, dict(EXP2, record_error_policy=policy))
    assert len(got[1]) == 3999
    assert got[4]["resyncs"] == 1
    assert got[4]["bytes_skipped"] == starts[1001] - starts[1000]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("site", ["before", "straddle", "after"])
def test_resync_across_a_window(tmp_path, monkeypatch, policy, site):
    """Windows of 4 KiB: a zeroed header just before a window's end, a
    garbage run that straddles the end and one just after it; the
    resync's search and chain run past the window, and the records after
    it are framed from the same device image or from the next window.
    One window per record would not do: the ledger's offsets, the rows
    and the skips must be the JAX package's whole-file ones."""
    monkeypatch.setattr(port_vlr, "READ_WINDOW_BYTES", 4096)
    clean = _clean()
    starts = faults.rdw_record_starts(clean)
    k = int(np.searchsorted(starts, 4096 * 3)) - (site == "before")
    if site == "straddle":
        data = faults.splice_garbage(clean, 4096 * 3 - 20,
                                     faults.garbage_run(48, seed=4))
    else:
        data = faults.zero_rdw(clean, starts[k + (site == "after")])
    options = dict(EXP2, record_error_policy=policy)
    _same(_write(tmp_path, "w.dat", data), options)


def test_a_clean_file_scans_once_a_window(tmp_path, monkeypatch):
    """A clean file costs the permissive policies what it costs
    fail_fast: one scan a window, and no ledger entry."""
    monkeypatch.setattr(port_vlr, "READ_WINDOW_BYTES", 4096)
    path = _write(tmp_path, "clean.dat", _clean())
    calls = []
    real = port_vlr.scan_window

    def counted(*a, **k):
        calls.append(a[1] if len(a) > 1 else k.get("start", 0))
        return real(*a, **k)

    monkeypatch.setattr(port_vlr, "scan_window", counted)
    counts = {}
    for policy in POLICIES:
        calls.clear()
        data = cobrix_tpu_torch.read_cobol(path, device="cpu",
                                           record_error_policy=policy,
                                           **EXP2)
        counts[policy] = len(calls)
        assert all(start == 0 for start in calls)
        if policy != "fail_fast":
            assert data.diagnostics.is_clean
    assert len(set(counts.values())) == 1


# -- the fixed-length torn tail ------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("tail", [0, 1, 700])
def test_fixed_length_torn_tail(tmp_path, monkeypatch, tail, policy,
                                pipelined):
    """A torn last record: fail_fast raises the message that names the
    permissive policy, permissive keeps it zero-padded with its reason,
    drop_malformed drops it; both ledger it. The port's 64 MiB chunks are
    cut small here, so the tail rides the last of several."""
    import cobrix_tpu_torch.api as port_api

    monkeypatch.setattr(port_api, "FIXED_READ_CHUNK_BYTES", 1493 * 7)
    data = gen.generate_exp1(40, seed=3).tobytes() \
        + gen.generate_exp1(1, seed=4).tobytes()[:tail]
    options = dict(copybook_contents=gen.EXP1_COPYBOOK,
                   record_error_policy=policy)
    if policy != "fail_fast":
        options["corrupt_record_column"] = "_bad"
    if pipelined:
        options.update(pipeline_workers="2", chunk_size_mb="0.01")
    got = _same(_write(tmp_path, "e1.dat", data), options)
    if tail and policy == "fail_fast":
        assert got[0] == "error" and "permissive" in got[2]
    elif tail:
        rows = 41 if policy == "permissive" else 40
        assert len(got[1]) == rows
        assert got[4]["corrupt_records"] == 1
        assert (got[1][-1][-1] is not None) == (policy == "permissive")


@pytest.mark.parametrize("policy", POLICIES)
def test_fixed_length_file_of_a_torn_record_alone(tmp_path, policy):
    data = gen.generate_exp1(1, seed=5).tobytes()[:300]
    _same(_write(tmp_path, "one.dat", data),
          dict(copybook_contents=gen.EXP1_COPYBOOK,
               record_error_policy=policy))


@pytest.mark.parametrize("policy", ["permissive", "drop_malformed"])
def test_fixed_length_segments_with_a_torn_tail(tmp_path, policy):
    from cobrix_tpu_torch.testing import generators as pgen

    data = pgen.generate_fixed_segments(30, seed=5).tobytes() + b"\xc3" * 9
    _same(_write(tmp_path, "seg.dat", data),
          dict(copybook_contents=pgen.FIXED_SEGMENTS_COPYBOOK,
               record_error_policy=policy, corrupt_record_column="BAD",
               **pgen.FIXED_SEGMENTS_OPTIONS))


# -- the options and their checks ----------------------------------------------

@pytest.mark.parametrize("options", [
    dict(record_error_policy="lenient"),
    dict(corrupt_record_column="_c"),
    dict(record_error_policy="permissive", resync_window="0"),
    dict(record_error_policy="permissive", resync_window="-5"),
    dict(record_error_policy="drop_malformed", corrupt_record_column="_c",
         max_corrupt_ledger_entries="1"),
    dict(record_extractor="x.Y", is_record_sequence="true"),
    dict(record_extractor="x.Y", is_text="true", record_length="4"),
    dict(record_length="9", is_text="true"),
    dict(record_length_field="REC-LEN", is_xcom="true"),
    dict(occurs_mappings="{}", occurs_mapping="{}"),
], ids=["bad_policy", "column_without_policy", "zero_window",
        "negative_window", "ledger_cap", "extractor_and_rdw",
        "extractor_and_text", "length_and_text", "length_field_and_xcom",
        "both_occurs_spellings"])
def test_option_checks(tmp_path, options):
    data, _ = _corrupt("several")
    _same(_write(tmp_path, "o.dat", data), dict(EXP2, **options))


def test_every_taken_option_is_parsed():
    """The options of this slice parse in the port, with the JAX
    package's defaults."""
    from cobrix_tpu.api import parse_options as jax_parse
    from cobrix_tpu_torch.api import parse_options as port_parse

    options = dict(record_error_policy="Permissive", resync_window="777",
                   max_corrupt_ledger_entries="3",
                   corrupt_record_column="_c", is_text="true",
                   encoding="ascii", variable_size_occurs="true",
                   re_additional_info="x", rhp_additional_info="y",
                   occurs_mappings='{"A": {"B": 1}}')
    want, _ = jax_parse(dict(options))
    got = port_parse(dict(options))
    for name in ("resync_window_bytes", "max_corrupt_ledger_entries",
                 "corrupt_record_column", "is_text", "variable_size_occurs",
                 "re_additional_info", "rhp_additional_info",
                 "occurs_mappings", "is_permissive", "supports_fast_framing",
                 "is_variable_length"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.record_error_policy.value == want.record_error_policy.value


def test_the_ledger_cap_keeps_the_earliest_entries(tmp_path):
    data, _ = _corrupt("several")
    got = _same(_write(tmp_path, "cap.dat", data),
                dict(EXP2, record_error_policy="permissive",
                     max_corrupt_ledger_entries="2",
                     input_split_records="40"), pipelined=True)
    assert got[4]["entries_truncated"] and len(got[4]["entries"]) == 2


# -- the resync search and the plain permissive scan ----------------------------

def _random_buffer(seed):
    """A clean RDW stream with a few headers broken at random."""
    rng = np.random.default_rng(seed)
    data = bytearray(gen.generate_exp2(int(rng.integers(20, 120)),
                                       seed=seed))
    starts = faults.rdw_record_starts(bytes(data))
    for s in rng.choice(starts, size=min(3, len(starts)), replace=False):
        data[int(s):int(s) + 4] = rng.integers(0, 256, 4,
                                                dtype=np.uint8).tobytes()
    cut = int(rng.integers(0, 40))
    return bytes(data[:len(data) - cut])


@pytest.mark.parametrize("seed", range(12))
def test_find_next_rdw_equals_the_jax_package(seed):
    buf = np.frombuffer(_random_buffer(seed), dtype=np.uint8)
    rng = np.random.default_rng(seed)
    for start in rng.integers(0, len(buf) - 8, size=25).tolist():
        for body_end in (None, len(buf)):
            for depth in (1, 3):
                args = (buf, start, start + 512, False, 0, body_end, depth)
                assert recovery.find_next_rdw(*args) \
                    == jax_recovery.find_next_rdw(*args)


@pytest.mark.parametrize("policy", ["permissive", "drop_malformed"])
@pytest.mark.parametrize("seed", range(6))
def test_plain_permissive_scan_equals_the_jax_package(seed, policy):
    data = _random_buffer(100 + seed)
    port_ledger, jax_ledger = ReadDiagnostics(), JaxDiagnostics()
    try:
        want = jax_recovery.rdw_scan_permissive(
            data, False, 0, 0, 0, JaxPolicy(policy), 2048, jax_ledger,
            "f.dat", 1000)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            recovery.rdw_scan_permissive(
                data, False, 0, 0, 0, RecordErrorPolicy(policy), 2048,
                port_ledger, "f.dat", 1000)
        assert str(got.value) == str(exc)
        return
    got = recovery.rdw_scan_permissive(
        data, False, 0, 0, 0, RecordErrorPolicy(policy), 2048, port_ledger,
        "f.dat", 1000)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert port_ledger.as_dict() == jax_ledger.as_dict()


@pytest.mark.parametrize("policy", ["permissive", "drop_malformed"])
@pytest.mark.parametrize("seed", range(4))
def test_device_framing_equals_the_plain_scan(seed, policy):
    """`frame_windows` (the scan kernel's plain version here, windows of
    2 KiB) gives the records, reasons and ledger of the plain
    `rdw_scan_permissive` over the same bytes."""
    import io

    import torch

    data = _random_buffer(200 + seed)
    plain_ledger, ledger = ReadDiagnostics(), ReadDiagnostics()
    pol = RecordErrorPolicy(policy)
    try:
        want = recovery.rdw_scan_permissive(data, False, 0, 0, 0, pol, 4096,
                                            plain_ledger, "f.dat")
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            list(port_vlr.frame_windows(
                io.BytesIO(data), len(data), torch.device("cpu"), False, 0,
                window_bytes=2048, policy=pol, ledger=ledger,
                file_name="f.dat", resync_window=4096))
        assert str(got.value) == str(exc)
        return
    reasons = {}
    offsets, lengths = [], []
    for base, _, o, ln in port_vlr.frame_windows(
            io.BytesIO(data), len(data), torch.device("cpu"), False, 0,
            window_bytes=2048, policy=pol, ledger=ledger, file_name="f.dat",
            resync_window=4096, corrupt_reasons=reasons):
        offsets.extend((base + o.numpy()).tolist())
        lengths.extend(ln.numpy().tolist())
    assert offsets == want[0].tolist()
    assert lengths == want[1].tolist()
    assert reasons == want[2]
    assert ledger.as_dict() == plain_ledger.as_dict()


def test_ledger_json_round_trips():
    data, _ = _corrupt("several")
    ledger = ReadDiagnostics()
    recovery.rdw_scan_permissive(data, False, 0, 0, 0,
                                 RecordErrorPolicy.PERMISSIVE, 4096, ledger,
                                 "x.dat")
    again = ReadDiagnostics.from_json(ledger.to_json())
    assert again.as_dict() == ledger.as_dict()
    assert JaxDiagnostics.from_json(ledger.to_json()).to_json() \
        == ledger.to_json()
