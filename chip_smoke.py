#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cobrix_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``cobrix_tpu_torch/csrc`` (into
``cobrix_tpu_torch/_build/``), then runs:

0. environment: the card's name and power limit, torch and CUDA
   versions, the kernel build time and its register report;
1. kernel vs plain, per kind: every case of the shared grid
   (``cobrix_tpu_torch.testing.kernel_cases``) over 4,096 random rows
   through the fused CUDA kernel and its plain PyTorch version on the
   card; exact equality;
2. the main path: a file of 1,000,000 exp1 records (1,493 bytes each)
   plus 1,024 random records, read with ``read_cobol`` on the default
   device. The fused kernel must launch once per 64 MiB chunk; every
   chunk's fused outputs are held against the plain version on the card
   over the same bytes, and the rows of the first 2,000 records and of
   the random tail against a ``device="cpu"`` decode of the same bytes;
3. the strided OCCURS layout: 50,000 exp3 wide records (16,064 bytes),
   framed on the host, kernel against plain on the card;
4. timings at the exp1 chunk and exp3 shapes, each the median of 20
   launches between CUDA events: ``kernel_ms`` (the kernels line's
   ``ms``) times a wrapper call on an idle stream, so the host's launch
   path is in it; ``device_ms`` holds the stream busy before each start
   event, so it is the launch's device time alone. Beside them the plain
   version, the byte bound, the share of it that the device time reaches
   and the achieved GB/s, and the card's name and power limit;
5. where one exp1 chunk's time goes: the file read, then one decode
   under ``torch.profiler`` (device time by kernel and copy, idle share).

Every failure exits non-zero. The last two lines are the kernels JSON and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it exits 2 and prints no result.

``--cpu-rehearsal`` runs the same phases at a small size on the CPU, with
the plain versions in place of the kernel, and exits 3 without the result
lines: it checks the script's paths, not the card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM device memory rate (NVIDIA data sheet), the byte bound's rate
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "cobrix_tpu_torch/csrc/fused_decode.cu"
REPLACES = "cobrix_tpu/ops/pallas_tpu.py:369"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, args):
        import numpy as np
        import torch

        self.np, self.torch = np, torch
        self.rehearsal = args.cpu_rehearsal
        self.device = torch.device("cpu" if self.rehearsal else "cuda")
        self.n_exp1 = 3000 if self.rehearsal else 1_000_000
        self.n_tail = 64 if self.rehearsal else 1024
        self.n_exp3 = 30 if self.rehearsal else 50_000
        self.grid_rows = 64 if self.rehearsal else 4096
        self.max_err = 0.0
        self.tmp = tempfile.mkdtemp(prefix="cobrix_smoke_")

    def sync(self):
        if not self.rehearsal:
            self.torch.cuda.synchronize()

    # -- comparisons ---------------------------------------------------

    def same(self, a, b, what):
        """Exact equality of two tensors or arrays (dtype included);
        records the largest absolute difference."""
        np = self.np
        if isinstance(a, self.torch.Tensor):
            a = a.cpu().numpy()
        if isinstance(b, self.torch.Tensor):
            b = b.cpu().numpy()
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        if not np.array_equal(a, b):
            diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
            self.max_err = max(self.max_err, float(np.nanmax(diff)))
            raise SmokeFailure(f"{what}: kernel and plain version differ "
                               f"at {int((a != b).sum())} places")

    # -- phases ------------------------------------------------------------

    def phase_env(self):
        torch = self.torch
        from cobrix_tpu_torch.ops import _build

        if not self.rehearsal:
            self.card = card_line()
            log(f"[env] card: {self.card}")
            log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
                f"device {torch.cuda.get_device_name(0)} "
                f"count {torch.cuda.device_count()}")
            t0 = time.perf_counter()
            _build.build()
            log(f"[env] kernel build {time.perf_counter() - t0:.2f} s")
            for name, (_, report) in sorted(_build.build_info.items()):
                regs = [l.strip() for l in report.splitlines()
                        if "registers" in l or "spill" in l]
                log(f"[env] {name}: {' | '.join(regs) or report.strip()}")
        else:
            self.card = "cpu rehearsal"
            log(f"[env] cpu rehearsal, torch {torch.__version__}")

    def phase_grid(self):
        torch = self.torch
        from cobrix_tpu_torch.ops.fused_decode import (
            FusedLayout, StridedGroup, fused_decode, fused_decode_plain)
        from cobrix_tpu_torch.testing.kernel_cases import (kernel_cases,
                                                           kernel_input)

        cases = kernel_cases()
        for i, (name, case) in enumerate(sorted(cases.items())):
            dicts, data = case(self.grid_rows, 1000 + i)
            groups = [StridedGroup.from_dict(d) for d in dicts]
            layout = FusedLayout(groups)
            x = kernel_input(name, data, self.device)
            got = layout.split(fused_decode(x, layout))
            want = fused_decode_plain(x, groups)
            for gi, (a_out, b_out) in enumerate(zip(got, want)):
                for k, (a, b) in enumerate(zip(a_out, b_out)):
                    self.same(a, b, f"grid {name} group {gi} output {k}")
        self.sync()
        log(f"[grid] {len(cases)} cases x {self.grid_rows} rows: kernel == "
            f"plain, exact")

    def _write_exp1(self, path):
        np = self.np
        from cobrix_tpu_torch.testing.generators import generate_exp1

        step = 100_000
        with open(path, "wb") as f:
            for k, start in enumerate(range(0, self.n_exp1, step)):
                f.write(generate_exp1(min(step, self.n_exp1 - start),
                                      seed=100 + k).tobytes())
            rs = 1493
            tail = np.random.default_rng(14).integers(
                0, 256, size=(self.n_tail, rs), dtype=np.uint8)
            f.write(tail.tobytes())
        return os.path.getsize(path)

    def phase_main(self):
        np, torch = self.np, self.torch
        import cobrix_tpu_torch.api as api
        from cobrix_tpu_torch import ColumnarDecoder, parse_copybook, read_cobol
        from cobrix_tpu_torch.ops.fused_decode import fused_decode, fused_decode_plain
        from cobrix_tpu_torch.reader.columnar import fused_group_spec
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        if self.rehearsal:
            api.FIXED_READ_CHUNK_BYTES = 1000 * 1493  # several chunks
        path = os.path.join(self.tmp, "exp1.dat")
        t0 = time.perf_counter()
        size = self._write_exp1(path)
        log(f"[main] wrote {self.n_exp1} exp1 records + {self.n_tail} random "
            f"records ({size} bytes) in {time.perf_counter() - t0:.1f} s")
        rs = 1493
        chunk = max(rs, api.FIXED_READ_CHUNK_BYTES // rs * rs)
        n_chunks = -(-size // chunk)

        # the main path, through the entry point a user calls
        kw = {"device": "cpu"} if self.rehearsal else {}
        fused_decode.launches = 0
        self.sync()
        t0 = time.perf_counter()
        data = read_cobol(path, copybook_contents=EXP1_COPYBOOK, **kw)
        self.sync()
        secs = time.perf_counter() - t0
        self.launches = fused_decode.launches
        log(f"[main] {self.card}: read_cobol: {len(data)} records, "
            f"{len(data.batches)} "
            f"chunks in {secs:.3f} s = {size / secs / 1e6:.1f} MB/s "
            f"end to end; fused kernel launches {self.launches}")
        check(len(data) == self.n_exp1 + self.n_tail, "record count")
        check(len(data.batches) == n_chunks, "chunk count")
        if not self.rehearsal:
            check(self.launches == n_chunks,
                  f"fused kernel launched {self.launches} times for "
                  f"{n_chunks} chunks")
        self.e2e = (size, secs)

        # every chunk's fused outputs against the plain version, same bytes
        dec = data.batches[0].decoder
        fused = [g for g in dec.kernel_groups
                 if fused_group_spec(g) is not None]
        with open(path, "rb") as f:
            for bi, batch in enumerate(data.batches):
                raw = np.frombuffer(f.read(batch.n_records * rs),
                                    dtype=np.uint8).reshape(-1, rs)
                x = torch.from_numpy(raw.copy()).to(self.device)
                want = fused_decode_plain(x, dec.fused.groups)
                for g, outs in zip(fused, want):
                    keys = (["values_hi", "values", "negative", "valid"]
                            if g.wide else ["values", "valid"])
                    if g.codec.name.startswith("DISPLAY"):
                        keys.append("dot_scale")
                    host = [o.cpu().numpy() for o in outs]
                    if g.wide:
                        host[0] = host[0].view(np.uint64)
                        host[1] = host[1].view(np.uint64)
                    for pos, c in enumerate(g.columns):
                        got = batch.column_arrays(c.index)
                        for key, arr in zip(keys, host):
                            self.same(got[key], arr[:, pos],
                                      f"chunk {bi} column {c.name} {key}")
        log(f"[main] {n_chunks} chunks x {len(fused)} fused groups: kernel "
            f"== plain on the same bytes, exact")
        self.exp1_chunk = data.batches[0].data

        # rows against a CPU decode of the same bytes
        cpu = ColumnarDecoder(parse_copybook(EXP1_COPYBOOK), device="cpu")
        head = data.batches[0].data[:2000]
        last = data.batches[-1]
        tail = last.data[last.n_records - self.n_tail:]
        for what, batch, base, raw in [
                ("head", data.batches[0], 0, head),
                ("tail", last, last.n_records - self.n_tail, tail)]:
            want_rows = cpu.decode(raw).to_rows()
            for i, row in enumerate(want_rows):
                check(batch.row(base + i) == row,
                      f"{what} record {i}: rows differ from the CPU decode")
        log(f"[main] rows of the first {len(head)} records and the "
            f"{self.n_tail}-record random tail == device='cpu' decode")
        os.remove(path)

    def phase_exp3(self):
        np, torch = self.np, self.torch
        from cobrix_tpu_torch import ColumnarDecoder, parse_copybook
        from cobrix_tpu_torch.ops.fused_decode import fused_decode, fused_decode_plain
        from cobrix_tpu_torch.testing.generators import (EXP3_COPYBOOK,
                                                         generate_exp3)

        t0 = time.perf_counter()
        wide, seed = [], 11
        while len(wide) < self.n_exp3:
            raw, pos = generate_exp3(3 * (self.n_exp3 - len(wide)) + 3,
                                     seed=seed), 0
            while pos < len(raw) and len(wide) < self.n_exp3:
                length = raw[pos + 2] | (raw[pos + 3] << 8)
                if length > 1000:  # the wide 'C' segment
                    wide.append(raw[pos + 4:pos + 4 + length])
                pos += 4 + length
            seed += 1
        arr = np.frombuffer(b"".join(wide), dtype=np.uint8).reshape(
            len(wide), -1)
        del wide
        log(f"[exp3] framed {arr.shape[0]} wide records of {arr.shape[1]} "
            f"bytes in {time.perf_counter() - t0:.1f} s")
        dec = ColumnarDecoder(parse_copybook(EXP3_COPYBOOK),
                              device=self.device)
        batch = dec.decode(arr)
        check(batch.n_records == arr.shape[0], "exp3 record count")
        x = torch.from_numpy(arr).to(self.device)
        got = dec.fused.split(fused_decode(x, dec.fused))
        want = fused_decode_plain(x, dec.fused.groups)
        for gi, (a_out, b_out) in enumerate(zip(got, want)):
            for k, (a, b) in enumerate(zip(a_out, b_out)):
                self.same(a, b, f"exp3 group {gi} output {k}")
        self.sync()
        log(f"[exp3] {len(dec.fused.groups)} fused groups "
            f"({dec.fused.n_cols} columns): kernel == plain, exact")
        self.exp3 = arr

    def _time(self, fn, reps, busy=False):
        """Median milliseconds of `reps` calls (CUDA events on the card,
        after warm-up). `busy` queues a sleep kernel before each start
        event, so the events bracket the launch's device time alone and
        not the host's path to it."""
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            if self.rehearsal:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if busy:
                torch.cuda._sleep(2_000_000)  # about 1 ms of device time
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def phase_timings(self):
        torch = self.torch
        from cobrix_tpu_torch import ColumnarDecoder, parse_copybook
        from cobrix_tpu_torch.ops.fused_decode import (fused_decode,
                                                       fused_decode_plain)
        from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                         EXP3_COPYBOOK)

        self.timings = {}
        for name, cb, arr in [("exp1", EXP1_COPYBOOK, self.exp1_chunk),
                              ("exp3", EXP3_COPYBOOK, self.exp3)]:
            layout = ColumnarDecoder(parse_copybook(cb),
                                     device=self.device).fused
            x = torch.from_numpy(arr).to(self.device)
            n = arr.shape[0]
            read, written = layout.bytes_per_record()
            moved = n * (read + written)
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            kernel_ms = self._time(lambda: fused_decode(x, layout), 20)
            device_ms = self._time(lambda: fused_decode(x, layout), 20,
                                   busy=True)
            plain_ms = self._time(
                lambda: fused_decode_plain(x, layout.groups), 5)
            self.timings[name] = dict(
                records=n, record_bytes=arr.shape[1], fused_columns=
                layout.n_cols, windows=len(layout.plan.windows),
                max_pitch=layout.max_pitch, bytes_read=n * read,
                bytes_written=n * written,
                kernel_ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, share_of_bound=bound_ms / device_ms,
                gb_per_s=moved / device_ms / 1e6, library_ms=None)
            log(f"[time] {self.card}: {name}: "
                f"{json.dumps(self.timings[name])}")
        size, secs = self.e2e
        log(f"[time] {self.card}: exp1 read_cobol end to end: {size} bytes "
            f"in {secs:.3f} s "
            f"= {size / secs / 1e6:.1f} MB/s; launches_per_read "
            f"{self.launches}")

    def phase_profile(self):
        """Where one exp1 chunk's time goes: the file read on the host
        clock, then one decode under torch.profiler (device time by
        kernel and copy, and the device's idle share of the wall)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from cobrix_tpu_torch import ColumnarDecoder, parse_copybook
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        arr = self.exp1_chunk
        path = os.path.join(self.tmp, "chunk.dat")
        with open(path, "wb") as f:
            f.write(arr.tobytes())
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            buf = bytearray(arr.nbytes)
            f.readinto(buf)
        read_ms = (time.perf_counter() - t0) * 1e3
        dec = ColumnarDecoder(parse_copybook(EXP1_COPYBOOK), device=self.device)
        dec.decode(arr)  # warm-up: allocator, gather indices, LUT
        self.sync()
        acts = [ProfilerActivity.CPU] + ([] if self.rehearsal
                                         else [ProfilerActivity.CUDA])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            dec.decode(arr)
            self.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device activity only (kernels and copies), as intervals: their
        # union is the busy time; the CPU-side ops that launched them
        # would count the same work twice
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or \
                    e.name.startswith("Activity Buffer"):
                continue
            spans.append((e.time_range.start, e.time_range.end))
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, count + 1)
        busy_us, reach = 0.0, None
        for a, b in sorted(spans):
            if reach is None or a > reach:
                busy_us += b - a
                reach = b
            elif b > reach:
                busy_us += b - reach
                reach = b
        self.profile = dict(chunk_records=arr.shape[0], read_ms=read_ms,
                            decode_wall_ms=wall_ms)
        if spans:
            busy_ms = busy_us / 1e3
            self.profile.update(device_busy_ms=busy_ms,
                                device_idle_share=1 - busy_ms / wall_ms)
        else:
            log("[profile] the trace holds no device time: busy and idle "
                "share not measured")
        log(f"[profile] {self.card}: exp1 chunk: {json.dumps(self.profile)}")
        for name, (ms, count) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:12]:
            log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {name[:90]}")

    def run(self):
        try:
            self.phase_env()
            self.phase_grid()
            self.phase_main()
            self.phase_exp3()
            self.phase_timings()
            self.phase_profile()
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)

    def result_lines(self):
        torch = self.torch
        t = self.timings["exp1"]
        kernels = {"kernels": [{
            "name": "fused_decode", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "launches": self.launches,
            "max_abs_err": self.max_err, "ms": t["kernel_ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None}]}
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
        return [self.card, json.dumps(kernels),
                json.dumps({"ok": True, "device": device})]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="small run on the CPU with the plain versions; "
                             "exits 3 without result lines")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "cobrix_tpu_torch")):
        print("chip_smoke: cobrix_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smoke = Smoke(args)
    try:
        smoke.run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if args.cpu_rehearsal:
        log("[rehearsal] all phases passed on the CPU; no result lines")
        return 3
    for line in smoke.result_lines():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
