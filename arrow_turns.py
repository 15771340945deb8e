#!/usr/bin/env python3
"""Time the port's Arrow assembly of several checkouts of this repository
on one GPU, in turns, on the same inputs.

    python3 arrow_turns.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout that holds ``cobrix_tpu_torch``.
The checkouts run in the order given, each in a process of its own that
imports only that checkout's package and builds its kernels there. The
inputs are made once, by this checkout's generators: an exp1 chunk
(44,949 records of 1,493 bytes, the first 64 MiB chunk's count), an
exp3 'C' batch (4,143 records of 16,064 bytes, the 'C' records of an
exp3 window) and one string array of 4,000,000 rows x 16 uint8 code
points (``testing/arrow_cases.strings``: 15,625 tiles, many waves).
Each checkout decodes the batches with its own decoder and builds their
assembly plans with its own builder (``build_plan`` timed on the host,
the median of 5), and the string array's plan from one `Request`. It
times each step of its own ``arrow_assemble.KERNELS`` from the state
before it, as ``chip_smoke.py`` phase 14 (c) does: ``ms`` (CUDA events
around a wrapper call on an idle stream) and ``device_ms`` (the stream
held busy first, so the events see device time alone), the median of 20
calls after 2, with the bytes of the step's bound. A wrapper is called
with the arguments its parameters name, the state's third tensor for any
other, so checkouts with other kernel sets run in turns (four steps
before the string lengths kernel took the offsets scan in, three
after). Each record gives ``string_first_device_ms``, the string path's
first part (the lengths and offsets steps, or the one lengths kernel),
and ``kernels_device_ms``, the sum over every step. Every checkout must
give the same output buffers (compared by hash). It prints the card's
name and power limit, one JSON line a run, and exits non-zero on any
difference.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import statistics
import sys
import time

import numpy as np

import framing_turns

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
EXP1_ROWS, EXP3_C_ROWS, STRING_ROWS = 44_949, 4_143, 4_000_000
# the string path's first part: lengths and the offsets scan, one kernel
# or two
STRING_FIRST = ("arrow_str_lengths", "arrow_str_offsets")


def make_inputs(directory):
    sys.path.insert(0, HERE)
    from cobrix_tpu_torch.testing import arrow_cases
    from cobrix_tpu_torch.testing import generators as g

    np.save(os.path.join(directory, "exp1.npy"),
            np.asarray(g.generate_exp1(EXP1_ROWS, seed=100)))
    wide, seed = [], 1011
    while len(wide) < EXP3_C_ROWS:
        raw, pos = g.generate_exp3(3 * (EXP3_C_ROWS - len(wide)) + 3,
                                   seed=seed), 0
        while pos < len(raw) and len(wide) < EXP3_C_ROWS:
            length = raw[pos + 2] | (raw[pos + 3] << 8)
            if length > 1000:   # the wide 'C' segment
                wide.append(raw[pos + 4:pos + 4 + length])
            pos += 4 + length
        seed += 1
    np.save(os.path.join(directory, "exp3c.npy"), np.frombuffer(
        b"".join(wide), dtype=np.uint8).reshape(len(wide), -1))
    requests, _ = arrow_cases.strings(STRING_ROWS, 16, seed=14)
    np.save(os.path.join(directory, "strings.npy"),
            requests[0].planes[0]["values"])


def moved_bytes(plan, res, asm):
    """The bytes each of the checkout's steps must move over this data,
    as phase 14's `_p14_bytes` counts them: each input read once (a
    hidden row's planes are not), each output written once; where the
    lengths kernel scans the tile sums itself, it counts the offsets
    step's work entries, tile bases and counters."""
    moved = dict.fromkeys(asm.KERNELS, 0)
    merged = "arrow_str_offsets" not in asm.KERNELS
    for i, r in enumerate(plan.requests):
        L, S = r.length, len(r.planes)
        rows = (np.repeat(np.asarray(r.rows), S) if r.rows is not None
                else np.arange(L) // S)
        seen = (L if r.mask is None
                else int(np.count_nonzero(np.asarray(r.mask)[rows])))
        tables = 8 * (L // S) * (r.rows is not None) + (
            L if r.mask is not None else 0)
        if r.is_string:
            cps = seen * r.width * (2 if r.src_kind == asm.SRC_CP16 else 1)
            tiles = -(-L // 256)
            moved["arrow_str_lengths"] += cps + tables + 4 * (L + 1) \
                + 8 * tiles
            if merged:   # a work entry read a tile, the counters written
                moved["arrow_str_lengths"] += 8 * tiles + 32
            else:        # a sum read and a base written a tile
                moved["arrow_str_offsets"] += 16 * tiles + 32
            moved["arrow_str_copy"] += cps + tables + 8 * L + 8 * tiles \
                + int(res.counters[i, asm.C_TOTAL])
            continue
        per = sum(p.itemsize for p in r.planes[0].values())
        moved["arrow_scalars"] += seen * per + tables + L * \
            asm.OUT_ITEMSIZE[r.out_kind] + 4 * -(-L // 32)
    return moved


def run_checkout(root, directory, reps):
    """One checkout's run (in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from cobrix_tpu_torch import ColumnarDecoder, parse_copybook
    from cobrix_tpu_torch.copybook.datatypes import SchemaRetentionPolicy
    from cobrix_tpu_torch.ops import arrow_assemble as asm
    from cobrix_tpu_torch.reader.arrow_out import ArrowBatchBuilder
    from cobrix_tpu_torch.testing import generators as g

    device = torch.device("cuda")

    def args_of(fn, src, aux, plan, state):
        """The arguments of step `fn` over `state`, by its parameters'
        names (the state's third tensor for any other)."""
        named = {"src": src, "aux": aux, "plan": plan, "out": state[0],
                 "tile_sums": state[1]}
        return [named.get(p, state[2])
                for p in inspect.signature(fn).parameters]

    def timed(fn, reset, busy):
        times = []
        for i in range(reps + 2):
            reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if busy:
                torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    def steps_of(plan):
        """The record of one plan: its output buffer's hash and each
        step's times from the state before it, restored before a
        call."""
        src, aux = asm.upload(plan)
        state = asm.new_state(plan, device)
        used = asm.run_steps(plan, src, aux, state)
        torch.cuda.synchronize()
        moved = moved_bytes(plan, asm.assemble(plan), asm)
        rec = dict(steps={}, hash=hashlib.sha256(
            state[0][:used].cpu().numpy().tobytes()).hexdigest()[:16])
        before = asm.new_state(plan, device)
        for step, fn in asm.KERNELS.items():
            if not (plan.str_tiles if "_str_" in step else plan.num_tiles):
                continue
            args = args_of(fn, src, aux, plan, before)
            snap = tuple(t.clone() for t in before)

            def reset(snap=snap):
                for a, b in zip(before, snap):
                    a.copy_(b)
            t = {key: timed(lambda: fn(*args), reset, busy)
                 for key, busy in (("ms", False), ("device_ms", True))}
            bound = moved[step] / HBM_BYTES_PER_S * 1e3
            t.update(bytes=moved[step], bound_ms=bound,
                     share_of_bound=bound / t["device_ms"])
            rec["steps"][step] = t
            reset()
            fn(*args)
        rec["string_first_device_ms"] = sum(
            t["device_ms"] for k, t in rec["steps"].items()
            if k in STRING_FIRST)
        rec["kernels_device_ms"] = sum(t["device_ms"]
                                       for t in rec["steps"].values())
        return rec

    out = {"checkout": root, "source": asm.__file__}
    batches = (
        ("exp1 chunk", g.EXP1_COPYBOOK, None, "exp1.npy"),
        ("exp3 'C' batch", g.EXP3_COPYBOOK, "STATIC_DETAILS", "exp3c.npy"))
    for what, copybook, active, name in batches:
        records = np.load(os.path.join(directory, name))
        batch = ColumnarDecoder(parse_copybook(copybook),
                                active_segment=active,
                                device=device).decode(records)
        builder = ArrowBatchBuilder(batch, active)
        builder.request_body(SchemaRetentionPolicy.KEEP_ORIGINAL)
        requests = builder.leaves.requests
        plan_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            plan = asm.build_plan(requests, batch.host_buffer, device)
            plan_s.append(time.perf_counter() - t0)
        out[what] = dict(rows=batch.n_records, requests=len(requests),
                         plan_ms=statistics.median(plan_s) * 1e3,
                         **steps_of(plan))
        del batch, plan
    # many waves of string tiles: one array, its rows one run of the
    # host buffer
    cps = np.load(os.path.join(directory, "strings.npy"))
    buf = torch.empty(cps.size, dtype=torch.uint8, pin_memory=True)
    view = buf.numpy().reshape(cps.shape)
    view[...] = cps
    plan = asm.build_plan([asm.Request(
        cps.shape[0], [{"values": view}], src_kind=asm.SRC_CP8,
        out_kind=asm.OUT_UTF8, width=cps.shape[1], trim=asm.TRIM_BOTH)],
        buf, device)
    out["string array"] = dict(rows=cps.shape[0], tiles=plan.str_tiles,
                               **steps_of(plan))
    print("TURN " + json.dumps(out), flush=True)


def main(argv=None):
    return framing_turns.main(argv, script=__file__, make=make_inputs,
                              run=run_checkout, label="arrow_turns",
                              description=__doc__)


if __name__ == "__main__":
    sys.exit(main())
