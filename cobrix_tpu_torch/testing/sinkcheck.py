"""Lakehouse-sink check: exactly-once commits under SIGKILL.

The port's counterpart of the JAX package's ``tools/sinkcheck.py``, as
a module of the package. It drives `cobrix_tpu_torch.sink` end to end,
every window decoded and every table built on `device` (the CUDA device
unless given ``--device cpu``, like every entry point):

  1. a `LiveAppender` grows a fixed-length file in torn, non-record-
     aligned increments while a consumer SUBPROCESS runs
     ``sink_cobol(tail_cobol(...), dataset_dir)`` with a durable
     checkpoint dir;
  2. a `SinkFaultPlan` kills the consumer (os._exit, SIGKILL-shaped)
     once in EACH commit window — pre_stage, post_stage, pre_commit,
     post_commit — across successive restarts (O_EXCL once-markers
     coordinate the sweep), plus one parent SIGKILL at a random
     instant;
  3. after the feed drains, `read_dataset` MUST be byte-identical to a
     one-shot `read_cobol(...).to_arrow()` of the final file: zero
     duplicates, zero gaps, across every kill window;
  4. the kills that landed after staging/finalize MUST have left
     quarantined orphans (the recovery evidence), and `fsck_sink` must
     report the dataset clean afterwards.

Each consumer that ends by itself (idle, or a planned kill) writes its
kernel launches next to the dataset (`check_kill_matrix` returns their
sum).

    python -m cobrix_tpu_torch.testing.sinkcheck                # on the card
    python -m cobrix_tpu_torch.testing.sinkcheck --device cpu   # plain versions
    python -m cobrix_tpu_torch.testing.sinkcheck --sweep        # + VRL, fuzz

Exit code 0 = every assertion held; 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

from .streamcheck import _launches, spawn, write_report

# this module's import name (also when run with ``python -m``)
_MODULE = __spec__.name if __spec__ is not None else __name__

COPYBOOK = """
        01  R.
            05  REGION PIC X(2).
            05  KEY    PIC 9(7) COMP.
            05  NAME   PIC X(9).
"""

RDW_COPYBOOK = """
        01  R.
            05  K  PIC X(6).
"""


def make_records(n: int, start: int = 0) -> bytes:
    return b"".join(
        ("EU" if i % 3 else "US").encode("cp037")
        + i.to_bytes(4, "big")
        + f"ROW{i % 1000000:06d}".encode("cp037")
        for i in range(start, start + n))


def make_rdw_records(n: int, start: int = 0) -> bytes:
    out = []
    for i in range(start, start + n):
        payload = f"K{i:05d}".encode("cp037")
        out.append(bytes([0, 0, len(payload) % 256,
                          len(payload) // 256]) + payload)
    return b"".join(out)


def consume(source: str, checkpoint_dir: str, dataset_dir: str,
            fault_dir: str, kill_points, options: dict, device=None,
            report_path: str = "", ingest: dict = None,
            target_file_mb: float = 0.1) -> int:
    """The consumer subprocess body: recover + sink until the feed is
    idle, dying wherever the installed fault plan says (after writing
    its report to `report_path`, when given). `ingest`: the ingestor's
    own arguments over the loop bounds below. Exit 0 = feed idle (the
    caller decides whether it is truly drained)."""
    from ..sink import sink_cobol
    from ..sink.writer import set_sink_fault_hook
    from ..streaming import tail_cobol
    from .faults import SinkFaultPlan, SinkKilled

    def report() -> None:
        if report_path:
            write_report(report_path, {"launches": _launches()})

    plan = SinkFaultPlan(fault_dir, action="raise")
    for point in kill_points:
        plan.kill(point)

    def hook(point: str, seq: int) -> None:
        try:
            plan(point, seq)
        except SinkKilled:
            report()
            os._exit(137)  # SIGKILL-shaped: no cleanup, no flush
    kw = dict(poll_interval_s=0.05, idle_timeout_s=1.0)
    kw.update(ingest or {})
    ing = tail_cobol(source, checkpoint_dir=checkpoint_dir,
                     finalize_on_idle=True, device=device, **kw,
                     **options)
    set_sink_fault_hook(hook)
    try:
        sink_cobol(ing, dataset_dir, target_file_mb=target_file_mb)
    finally:
        set_sink_fault_hook(None)
    report()
    return 0


def check_kill_matrix(tag: str, payload: bytes, options: dict,
                      parent_kill: bool = True, device=None,
                      slice_sizes=(7, 3, 11, 2, 29),
                      pause_s: float = 0.003, head: int = 0,
                      parent_kill_after_s: float = 0.2,
                      deadline_s: float = 240.0, work_dir: str = "",
                      ingest: dict = None,
                      target_file_mb: float = 0.1) -> dict:
    """Grow a file tornly (from its first `head` bytes, a quarter by
    default); kill/restart the sinking consumer through every commit
    window; assert dataset == one-shot read on `device` + recovery
    evidence + fsck-clean. Returns a report ({"ok": bool, ...}: rows,
    cycles, kill windows fired, quarantined orphans and the consumers'
    summed launches)."""
    import pyarrow as pa  # noqa: F401 — fail fast if missing

    from .. import read_cobol
    from ..sink import fsck_sink, read_dataset
    from .faults import SINK_KILL_POINTS, LiveAppender

    work = tempfile.mkdtemp(prefix=f"sinkcheck-{tag}-",
                            dir=work_dir or None)
    src = os.path.join(work, "feed.dat")
    ckpt = os.path.join(work, "ckpt")
    faults = os.path.join(work, "faults")
    dataset = os.path.join(work, "dataset")
    os.makedirs(faults)
    head = head or len(payload) // 4
    with open(src, "wb") as f:
        f.write(payload[:head])
    appender = LiveAppender(src, payload[head:], slice_sizes=slice_sizes,
                            pause_s=pause_s).start()
    cycles = 0
    launches = {}
    result = {"ok": False, "tag": tag, "parent_killed": False}
    deadline = time.monotonic() + deadline_s
    t_start = time.monotonic()
    while True:
        report_path = os.path.join(work, f"report{cycles}.json")
        fired_before = len(os.listdir(faults))
        proc = spawn(_MODULE, "consume", src, ckpt, dataset, faults,
                     list(SINK_KILL_POINTS), options,
                     None if device is None else str(device),
                     report_path, ingest or {}, target_file_mb)
        killed = False
        if parent_kill and cycles == 1:
            # one cycle dies by PARENT SIGKILL at a random instant on
            # top of the deterministic window sweep
            time.sleep(parent_kill_after_s)
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                killed = result["parent_killed"] = True
        rc = proc.wait()
        cycles += 1
        if os.path.exists(report_path):
            with open(report_path) as f:
                for k, v in json.load(f)["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        planned = rc == 137 and len(os.listdir(faults)) > fired_before
        if not killed and rc != 0 and not planned:
            print(f"FAIL [{tag}]: consumer exited {rc}")
            return result
        if rc == 0 and appender.done:
            break
        if time.monotonic() > deadline:
            print(f"FAIL [{tag}]: kill/restart loop did not drain "
                  f"within {deadline_s:.0f}s (rc={rc})")
            return result
    result["drain_s"] = time.monotonic() - t_start
    fired = sorted(os.listdir(faults))
    if len(fired) < len(SINK_KILL_POINTS):
        print(f"FAIL [{tag}]: only {fired} kill window(s) fired")
        return result
    got = read_dataset(dataset)
    want = read_cobol(src, device=device, **options).to_arrow() \
        .replace_schema_metadata(None)
    if not got.equals(want):
        print(f"FAIL [{tag}]: dataset != one-shot read "
              f"({got.num_rows} vs {want.num_rows} rows over "
              f"{cycles} kill cycles)")
        return result
    # kills after staging/finalize leave quarantined orphans — the
    # recovery evidence the crash windows MUST produce
    held = os.listdir(os.path.join(dataset, "quarantine")) \
        if os.path.isdir(os.path.join(dataset, "quarantine")) else []
    if not held:
        print(f"FAIL [{tag}]: post-stage kills left no quarantined "
              "orphans (recovery did not run?)")
        return result
    report = fsck_sink(dataset)
    if not report["clean"]:
        print(f"FAIL [{tag}]: fsck reports the recovered dataset "
              f"unclean: {report}")
        return result
    result.update(ok=True, rows=got.num_rows, cycles=cycles,
                  windows=fired, quarantined=len(held),
                  bytes=os.path.getsize(src), launches=launches)
    print(f"ok [{tag}]: {got.num_rows} rows byte-identical across "
          f"{cycles} kill/restart cycles ({len(fired)} kill windows, "
          f"{len(held)} quarantined orphan(s), fsck clean)")
    return result


def check_kill_fuzz(tag: str, payload: bytes, options: dict,
                    kills: int = 6, seed: int = 0, device=None) -> bool:
    """Randomized kill fuzz (the --sweep tier): each cycle kills at a
    random window via a fresh fault dir, until the feed drains."""
    import random

    from .. import read_cobol
    from ..sink import read_dataset
    from .faults import SINK_KILL_POINTS, LiveAppender

    rng = random.Random(seed)
    work = tempfile.mkdtemp(prefix=f"sinkcheck-fuzz-{tag}-")
    src = os.path.join(work, "feed.dat")
    ckpt = os.path.join(work, "ckpt")
    dataset = os.path.join(work, "dataset")
    with open(src, "wb") as f:
        f.write(payload[:len(payload) // 3])
    appender = LiveAppender(src, payload[len(payload) // 3:],
                            slice_sizes=(13, 5, 31),
                            pause_s=0.002).start()
    cycles = 0
    deadline = time.monotonic() + 300
    while True:
        fault_dir = os.path.join(work, f"faults-{cycles}")
        os.makedirs(fault_dir, exist_ok=True)
        points = ([rng.choice(SINK_KILL_POINTS)]
                  if cycles < kills else [])
        proc = spawn(_MODULE, "consume", src, ckpt, dataset, fault_dir,
                     points, options,
                     None if device is None else str(device))
        rc = proc.wait()
        cycles += 1
        if rc == 0 and appender.done:
            break
        if time.monotonic() > deadline:
            print(f"FAIL [{tag}]: fuzz loop did not drain (rc={rc})")
            return False
    got = read_dataset(dataset)
    want = read_cobol(src, device=device, **options).to_arrow() \
        .replace_schema_metadata(None)
    if not got.equals(want):
        print(f"FAIL [{tag}]: fuzz dataset != one-shot "
              f"({got.num_rows} vs {want.num_rows} rows)")
        return False
    print(f"ok [{tag}]: fuzz {got.num_rows} rows byte-identical over "
          f"{cycles} cycles")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="+ VRL and random kill fuzz (slow)")
    ap.add_argument("--records", type=int, default=4000)
    ap.add_argument("--device", default=None,
                    help="decode device (default: the CUDA device)")
    args = ap.parse_args(argv)
    fixed_opts = {"copybook_contents": COPYBOOK}
    ok = check_kill_matrix("fixed", make_records(args.records),
                           fixed_opts, device=args.device)["ok"]
    if args.sweep:
        vrl_opts = {"copybook_contents": RDW_COPYBOOK,
                    "is_record_sequence": "true",
                    "generate_record_id": "true"}
        ok = check_kill_matrix(
            "vrl", make_rdw_records(args.records), vrl_opts,
            device=args.device)["ok"] and ok
        ok = check_kill_fuzz(
            "fixed", make_records(args.records * 2), fixed_opts,
            device=args.device) and ok
    print("SINKCHECK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
