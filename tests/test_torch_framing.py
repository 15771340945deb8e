"""The port's RDW scan and record pack against the JAX package's.

The same numpy bytes go through ``cobrix_tpu.native.rdw_scan`` /
``native.pack_records`` (the host walk the JAX reader frames with),
``cobrix_tpu.ops.device_framing.rdw_scan_device`` /
``pack_records_device`` (its device formulation) and the port's plain
versions (``cobrix_tpu_torch.ops.device_framing``; a CPU tensor runs
them), through the framing of the port's reader
(``var_len_reader.frame_windows``): with its default window, one window
frames the whole image, and with small windows records straddle window
cuts. Tolerance: exact, errors included (exception class,
message, offset, reason and header bytes).
"""
import io

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cobrix_tpu import native
from cobrix_tpu.ops.device_framing import (pack_records_device,
                                           rdw_scan_device)
from cobrix_tpu.reader.diagnostics import FramingError as JaxFramingError
from cobrix_tpu_torch.ops import device_framing as df
from cobrix_tpu_torch.reader import var_len_reader as vlr
from cobrix_tpu_torch.reader.diagnostics import FramingError
from cobrix_tpu_torch.testing.framing_cases import (WINDOWS, pack_case,
                                                    rdw_header, rdw_stream,
                                                    scan_cases)

MAX = native.MAX_RDW_RECORD_SIZE
CASES = scan_cases()


def _outcome(fn):
    """("ok", offsets, lengths) or ("error", class name, message, offset,
    reason, header)."""
    try:
        offsets, lengths = fn()
    except (FramingError, JaxFramingError) as e:
        return ("error", type(e).__name__, str(e), e.offset, e.reason,
                e.header)
    return ("ok", np.asarray(offsets, dtype=np.int64).tolist(),
            np.asarray(lengths, dtype=np.int64).tolist())


def _native(image, big_endian, adj, header, footer):
    return _outcome(lambda: native.rdw_scan(
        np.frombuffer(image, np.uint8), big_endian, adj, header, footer))


def _windowed(image, big_endian, adj, header, footer, device="cpu"):
    def run():
        offs, lens = [], []
        for base, _, o, ln in vlr.frame_windows(
                io.BytesIO(image), len(image), device, big_endian, adj,
                header, footer):
            offs.extend((base + o.cpu().numpy()).tolist())
            lens.extend(ln.cpu().numpy().tolist())
        return offs, lens
    return _outcome(run)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_matches_native(name):
    image, big_endian, adj, header, footer = CASES[name]
    want = _native(image, big_endian, adj, header, footer)
    assert len(image) <= vlr.READ_WINDOW_BYTES  # one window
    assert _windowed(image, big_endian, adj, header, footer) == want


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_windowed_scan_matches_native(name, window, monkeypatch):
    monkeypatch.setattr(vlr, "READ_WINDOW_BYTES", window)
    image, big_endian, adj, header, footer = CASES[name]
    assert _windowed(image, big_endian, adj, header, footer) == \
        _native(image, big_endian, adj, header, footer)


def test_errors_name_the_jax_package_class_and_fields():
    image, big_endian, adj, header, footer = CASES["zero_header"]
    want = _native(image, big_endian, adj, header, footer)
    assert want[0] == "error" and want[1] == "FramingError"
    assert want[3] > 0 and want[4] == "zero-length RDW header"
    image, big_endian, adj, header, footer = CASES[
        "oversized_after_file_header"]
    want = _native(image, big_endian, adj, header, footer)
    assert want[0] == "error" and want[4] == "oversized RDW header"
    assert want[3] == 10
    assert _windowed(image, big_endian, adj, header, footer) == want


@pytest.mark.parametrize("name", ["le", "be", "part_of_length",
                                  "positive_adjustment", "truncated_last"])
def test_scan_matches_jax_device_scan(name):
    image, big_endian, adj, _, _ = CASES[name]
    want = rdw_scan_device(image, big_endian, adj)
    got = _windowed(image, big_endian, adj, 0, 0)
    assert got[0] == "ok"
    for a, b in zip(got[1:], want):
        assert a == np.asarray(b, dtype=np.int64).tolist()


def test_scan_window_carries_an_unfinished_record():
    image = rdw_stream([10, 20, 30], seed=3)
    tensor = torch.from_numpy(np.frombuffer(image, np.uint8).copy())
    offs, lens, status = df.scan_window(tensor[:45], 0, False)
    assert offs.tolist() == [4, 18] and lens.tolist() == [10, 20]
    assert status == df.WindowStatus(df.CARRY, 38, 30)
    offs, lens, status = df.scan_window(tensor[:40], 0, False)
    assert status == df.WindowStatus(df.CARRY, 38, 0)  # header cut
    offs, lens, status = df.scan_window(tensor[:36], 0, False)
    assert offs.tolist() == [4] and status == df.WindowStatus(df.CARRY, 14, 20)
    offs, lens, status = df.scan_window(tensor[:16], 0, False)
    assert offs.tolist() == [4] and status == df.WindowStatus(df.CARRY, 14, 0)
    offs, lens, status = df.scan_window(tensor, 14, True)
    assert offs.tolist() == [18, 42] and status.code == df.DONE


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       window=st.sampled_from([6, 29, 64, 301, 4096]),
       big_endian=st.booleans(),
       delta=st.sampled_from([0, 4, -2]),
       header=st.integers(0, 12), footer=st.integers(0, 9),
       tail=st.integers(0, 5), corrupt=st.booleans())
def test_random_streams(seed, window, big_endian, delta, header, footer,
                        tail, corrupt):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 200, size=int(rng.integers(0, 40))).tolist()
    body = bytearray(rdw_stream(lengths, big_endian, delta, seed))
    if corrupt and lengths:
        k = int(rng.integers(0, len(lengths)))
        at = sum(4 + ln for ln in lengths[:k])
        body[at:at + 4] = rdw_header(-delta, big_endian)  # length 0
    image = (rng.integers(0, 256, size=header, dtype=np.uint8).tobytes()
             + bytes(body)
             + rng.integers(0, 256, size=tail + footer,
                            dtype=np.uint8).tobytes())
    want = _native(image, big_endian, -delta, header, footer)
    assert _windowed(image, big_endian, -delta, header, footer) == want
    saved = vlr.READ_WINDOW_BYTES
    vlr.READ_WINDOW_BYTES = window
    try:
        assert _windowed(image, big_endian, -delta, header, footer) == want
    finally:
        vlr.READ_WINDOW_BYTES = saved


@pytest.mark.parametrize("extent", [0, 1, 5, 16, 17, 64, 333])
@pytest.mark.parametrize("start_offset", [0, 3])
def test_pack_matches_native(extent, start_offset):
    image, offsets, lengths = pack_case()
    want = native.pack_records(image, offsets, lengths, extent,
                               start_offset=start_offset)
    got = df.pack_records(torch.from_numpy(image), torch.from_numpy(offsets),
                          torch.from_numpy(lengths), extent, start_offset)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("extent", [1, 16, 17, 64])
def test_pack_matches_jax_device_pack(extent):
    image, offsets, lengths = pack_case()
    inside = (offsets >= 0) & (lengths > 0) & (offsets + np.maximum(
        lengths, 0) <= image.size)
    offsets, lengths = offsets[inside], lengths[inside]
    want = np.asarray(pack_records_device(image, offsets, lengths, extent))
    got = df.pack_records(torch.from_numpy(image), torch.from_numpy(offsets),
                          torch.from_numpy(lengths), extent)
    assert np.array_equal(got.numpy(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    image = torch.zeros(10, dtype=torch.uint8)
    offs = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="1-D uint8"):
        df.scan_window(image.view(2, 5))
    with pytest.raises(ValueError, match="outside the window"):
        df.scan_window(image, 11)
    with pytest.raises(ValueError, match="int64 offsets"):
        df.pack_records(image, offs.int(), offs, 4)
    with pytest.raises(ValueError, match="as many lengths"):
        df.pack_records(image, offs, offs[:1], 4)
    with pytest.raises(TypeError):
        df.pack_records(image.numpy(), offs, offs, 4)


@pytest.mark.cuda
def test_framing_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the framing kernels have no CPU "
                    "mode")
    dev = torch.device("cuda")
    for name, (image, big_endian, adj, header, footer) in CASES.items():
        cpu = torch.from_numpy(np.frombuffer(image, np.uint8).copy())
        for window in WINDOWS:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(vlr, "READ_WINDOW_BYTES", window)
                want = _windowed(image, big_endian, adj, header, footer)
                got = _windowed(image, big_endian, adj, header, footer,
                                dev)
            assert got == want, name
        for cut in (5, 37):
            for last in (False, True):
                if cut > cpu.numel():
                    continue
                a = df.scan_window_plain(cpu[:cut], 0, last, big_endian, adj)
                b = df.scan_window(cpu[:cut].to(dev), 0, last, big_endian,
                                   adj)
                assert [x.tolist() for x in a[:2]] == \
                    [x.cpu().tolist() for x in b[:2]] and a[2] == b[2], name
    image, offsets, lengths = pack_case()
    for extent in (1, 16, 17, 333):
        for start in (0, 3):
            want = df.pack_records(torch.from_numpy(image),
                                   torch.from_numpy(offsets),
                                   torch.from_numpy(lengths), extent, start)
            got = df.pack_records(torch.from_numpy(image).to(dev),
                                  torch.from_numpy(offsets).to(dev),
                                  torch.from_numpy(lengths).to(dev), extent,
                                  start)
            assert torch.equal(got.cpu(), want)
