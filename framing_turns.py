#!/usr/bin/env python3
"""Time the port's RDW scan and record pack of several checkouts of this
repository on one GPU, in turns, on the same inputs.

    python3 framing_turns.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout that holds ``cobrix_tpu_torch``.
The checkouts run in the order given, each in a process of its own that
imports only that checkout's package and builds its kernels there. The
inputs are made once, by this checkout's generators: the first 64 MiB
of an exp3 and of an exp2 RDW stream, framed as a window that is not the
last. Each run times, as the median of 20 calls between CUDA events
after 3 warm-up calls (a wrapper call on an idle stream, as the `ms` of
``chip_smoke.py``): the scan of each window (``scan_window`` at its
default tile) and the three packs of the RDW main path, exp3's 'C'
segment (16,064-byte rows), exp2's 'P' segment (60-byte rows) and exp2's
segment-id field (the first 5 bytes of every record), each beside one
PyTorch indexing call, ``image[gather]``. Every checkout must give the
same outputs (compared by hash). It prints the card's name and power
limit, one JSON line a run, and exits non-zero on any difference.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW = 64 * 1024 * 1024
# (kind, records a part, first seed): 8 parts make a little over 64 MiB
STREAMS = (("exp3", 1600, 11), ("exp2", 135_000, 200))
SEGMENT_C, SEGMENT_P = 0xC3, 0xD7  # EBCDIC 'C' and 'P'


def _part(job):
    kind, n, seed = job
    sys.path.insert(0, HERE)
    from cobrix_tpu_torch.testing import generators

    return getattr(generators, f"generate_{kind}")(n, seed=seed)


def make_inputs(directory):
    """Each window's bytes, and the record indices of each pack shape from
    a sequential walk of the window's headers."""
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        for kind, n, seed in STREAMS:
            data = b"".join(pool.map(_part, [(kind, n, seed + k)
                                             for k in range(8)]))
            assert len(data) > WINDOW, len(data)
            window = np.frombuffer(data[:WINDOW], dtype=np.uint8)
            starts, pos = [], 0
            while pos + 4 <= WINDOW:
                length = int(window[pos + 2]) | int(window[pos + 3]) << 8
                if pos + 4 + length > WINDOW:
                    break
                starts.append(pos)
                pos += 4 + length
            ids = window[np.asarray(starts) + 4]
            np.save(os.path.join(directory, f"{kind}.npy"), window)
            np.save(os.path.join(directory, f"{kind}.C.npy"),
                    np.nonzero(ids == SEGMENT_C)[0])
            np.save(os.path.join(directory, f"{kind}.P.npy"),
                    np.nonzero(ids == SEGMENT_P)[0])


def run_checkout(root, directory, reps):
    """One checkout's run (in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from cobrix_tpu_torch.ops import device_framing as df

    def time_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {"checkout": root, "source": df.__file__}
    for kind, _, _ in STREAMS:
        window = np.load(os.path.join(directory, f"{kind}.npy"))
        image = torch.from_numpy(window).cuda()
        offs, lens, status = df.scan_window(image, 0, False)
        out[f"{kind}_scan"] = dict(
            ms=time_ms(lambda: df.scan_window(image, 0, False)),
            records=int(offs.numel()), status=list(status),
            hash=digest(offs, lens))
        shapes = [("segment_id", None, 5)] if kind == "exp2" else []
        shapes.append(("C", "C", 16064) if kind == "exp3" else ("P", "P", 60))
        for name, segment, extent in shapes:
            if segment is None:
                o, ln = offs, lens
            else:
                idx = torch.from_numpy(np.load(os.path.join(
                    directory, f"{kind}.{segment}.npy"))).cuda()
                o, ln = offs[idx], lens[idx]
            packed = df.pack_records(image, o, ln, extent)
            cols = torch.arange(extent, device=image.device)
            gather = torch.clamp(o[:, None] + cols[None, :], 0,
                                 image.numel() - 1)
            out[f"{kind}_pack_{name}"] = dict(
                rows=int(o.numel()), extent=extent,
                ms=time_ms(lambda: df.pack_records(image, o, ln, extent)),
                library_ms=time_ms(lambda: image[gather]),
                hash=digest(packed))
            del gather, packed
    print("TURN " + json.dumps(out), flush=True)


def main(argv=None, script=__file__, make=make_inputs, run=run_checkout,
         label="framing_turns", description=__doc__):
    """Run `run` (a checkout's timings, printing one ``TURN`` JSON line)
    for each checkout in its own process of `script`, on the inputs
    `make` writes once; the other turns scripts call this with theirs."""
    parser = argparse.ArgumentParser(description=description.splitlines()[0])
    parser.add_argument("checkouts", nargs="+")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--inputs", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        run(args.child, args.inputs, args.reps)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix=f"{label}_") as tmp:
        make(tmp)
        for root in args.checkouts:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(script), root, "--child",
                 root, "--inputs", tmp, "--reps", str(args.reps)],
                capture_output=True, text=True, timeout=900)
            lines = [l for l in proc.stdout.splitlines()
                     if l.startswith("TURN ")]
            if proc.returncode != 0 or not lines:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(lines[0][5:]))
            print(f"{card}: {json.dumps(runs[-1])}", flush=True)
    hashes = {json.dumps({k: v.get("hash") for k, v in r.items()
                          if isinstance(v, dict)}, sort_keys=True)
              for r in runs}
    if len(hashes) != 1:
        print(f"{label}: the checkouts' outputs differ", file=sys.stderr)
        return 1
    print(f"{label}: every checkout gave the same outputs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
