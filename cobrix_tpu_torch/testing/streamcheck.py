"""Continuous-ingestion check: exactly-once under SIGKILL.

The port's counterpart of the JAX package's ``tools/streamcheck.py``,
as a module of the package. It drives `cobrix_tpu_torch.streaming` end
to end, every window decoded on `device` (the CUDA device unless given
``--device cpu``, like every entry point):

  1. a `LiveAppender` grows a fixed-length file in torn, non-record-
     aligned increments while a consumer SUBPROCESS tails it with a
     durable checkpoint dir, appending every delivered batch to an
     output log and acking each batch with the output length
     (`app_state`) — the exactly-once recipe;
  2. the consumer is killed repeatedly — both by its own os._exit
     mid-stream and by a parent SIGKILL at a random instant — and
     restarted from the checkpoint until the feed drains;
  3. the concatenation of the surviving output batches MUST be
     byte-identical to a one-shot `read_cobol(...).to_arrow()` of the
     final file, and the batches' byte ranges must tile the file in
     order: zero duplicates, zero gaps, monotone record positions,
     across every kill.

The JAX harness's fourth part, follow-mode parity over the serve tier,
waits for the port's serve tier.

Each consumer that ends by itself (idle, or its own planned os._exit)
writes a report next to the output log: its kernel launches, the bytes
and seconds of its drain, and each batch's time from the poll that
found its bytes to its yield (`check_exactly_once` returns them).

    python -m cobrix_tpu_torch.testing.streamcheck                # on the card
    python -m cobrix_tpu_torch.testing.streamcheck --device cpu   # plain versions
    python -m cobrix_tpu_torch.testing.streamcheck --sweep        # + VRL, more kills

Exit code 0 = every assertion held; 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import struct
import subprocess
import sys
import tempfile
import time

# the checkout root: consumer subprocesses import the package from it
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# this module's import name (also when run with ``python -m``)
_MODULE = __spec__.name if __spec__ is not None else __name__

COPYBOOK = """
        01  R.
            05  KEY    PIC 9(7) COMP.
            05  NAME   PIC X(9).
"""
RECORD_BYTES = 13

RDW_COPYBOOK = """
        01  R.
            05  K  PIC X(6).
"""


def make_records(n: int, start: int = 0) -> bytes:
    return b"".join(
        (start + i).to_bytes(4, "big")
        + f"ROW{(start + i) % 1000000:06d}".encode("ascii")
        for i in range(n))


def make_rdw_records(n: int, start: int = 0) -> bytes:
    out = []
    for i in range(start, start + n):
        payload = f"K{i:05d}".encode("cp037")
        out.append(bytes([0, 0, len(payload) % 256,
                          len(payload) // 256]) + payload)
    return b"".join(out)


def make_corpus_records(n: int) -> bytes:
    """Encoder-built TXN corpus (`testing.corpus`) as the live feed:
    continuous ingestion exercised on multi-field encoder-produced
    records (COMP-3, big/little-endian binary, DISPLAY decimals)."""
    from . import corpus as _corpus

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "txn.dat")
        _corpus.write_fixed_corpus(path, n, seed=33)
        with open(path, "rb") as f:
            return f.read()


# -- durable output log (the consumer side of exactly-once) ---------------

def append_batch(out_path: str, table, offset_from: int = 0,
                 offset_to: int = 0) -> int:
    """Serialize one Arrow table as a length-framed IPC segment (its
    byte range of the source in the schema metadata), append + fsync,
    return the new durable length (the app_state the matching ack
    commits)."""
    import pyarrow as pa

    meta = dict(table.schema.metadata or {})
    meta[b"streamcheck.range"] = f"{offset_from}:{offset_to}".encode()
    table = table.replace_schema_metadata(meta)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    payload = sink.getvalue().to_pybytes()
    with open(out_path, "ab") as f:
        f.write(struct.pack(">I", len(payload)) + payload)
        f.flush()
        os.fsync(f.fileno())
        return f.tell()


def read_output(out_path: str, ranges=None):
    """Every complete framed segment -> list of tables (a torn final
    frame — the crash window — is ignored, exactly what truncate-to-
    app_state would have removed). `ranges`, when a list, receives each
    segment's (offset_from, offset_to)."""
    import pyarrow as pa

    tables = []
    try:
        data = open(out_path, "rb").read()
    except OSError:
        return tables
    pos = 0
    while pos + 4 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if pos + 4 + n > len(data):
            break
        with pa.ipc.open_stream(data[pos + 4:pos + 4 + n]) as r:
            table = r.read_all()
        meta = dict(table.schema.metadata or {})
        span = meta.pop(b"streamcheck.range", b"0:0").decode()
        if ranges is not None:
            ranges.append(tuple(int(v) for v in span.split(":")))
        tables.append(table.replace_schema_metadata(meta or None))
        pos += 4 + n
    return tables


def _launches() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from ..ops import arrow_assemble as asm
    from ..ops import device_framing as df
    from ..ops.fused_decode import fused_decode

    return {"fused_decode": fused_decode.launches,
            "rdw_scan": df.scan_window.launches,
            "pack_records": df.pack_records.launches,
            **{k: fn.launches for k, fn in asm.KERNELS.items()}}


def _timed_ingestor(**kwargs):
    """A `ContinuousIngestor` that notes each batch's seconds from the
    start of the poll that found its bytes to its yield."""
    from ..streaming.ingest import ContinuousIngestor

    class Timed(ContinuousIngestor):
        def _drain_source(self, live):
            t0 = time.monotonic()
            for batch in super()._drain_source(live):
                self.latencies.append(time.monotonic() - t0)
                yield batch

    ing = Timed(**kwargs)
    ing.latencies = []
    return ing


def write_report(path: str, report: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)


def consume(source: str, checkpoint_dir: str, out_path: str,
            crash_after: int, options: dict, device=None,
            report_path: str = "", ingest: dict = None) -> int:
    """The consumer subprocess body: resume from the checkpoint,
    truncate the output to the committed app_state, ingest + ack until
    idle, optionally dying after `crash_after` batches. Exit 0 = feed
    idle (caller decides whether it is truly done). `ingest`: the
    ingestor's own arguments (``batch_max_mb``, ...) over the loop
    bounds below. With `report_path`, the consumer writes its report
    there before it ends by itself."""
    kw = dict(poll_interval_s=0.05, idle_timeout_s=1.0)
    kw.update(ingest or {})
    ing = _timed_ingestor(path=source, checkpoint_dir=checkpoint_dir,
                          auto_ack=False, finalize_on_idle=True,
                          device=device, **kw, **options)
    committed = int(ing.app_state or 0)
    with open(out_path, "ab") as f:
        f.truncate(committed)
    batches = delivered = 0
    t0 = t_last = time.monotonic()

    def report() -> None:
        # the drain's seconds end at its last batch (the idle wait
        # after it is not drain time)
        if report_path:
            write_report(report_path, {
                "launches": _launches(), "batches": batches,
                "bytes": delivered, "seconds": t_last - t0,
                "latencies_s": list(ing.latencies),
                "staging": ing.staging.report()})
    for batch in ing:
        new_len = append_batch(out_path, batch.to_arrow(),
                               batch.offset_from, batch.offset_to)
        batch.ack(app_state=new_len)
        batches += 1
        delivered += batch.offset_to - batch.offset_from
        t_last = time.monotonic()
        if crash_after and batches >= crash_after:
            report()
            os._exit(137)  # SIGKILL-shaped: no cleanup, no flush
    report()
    return 0


def spawn(module: str, function: str, *args) -> subprocess.Popen:
    """`module.function(*args)` in a fresh interpreter that imports the
    package from this checkout (JSON-encoded arguments); its return
    value is the exit code."""
    code = (
        "import sys, json; sys.path.insert(0, {root!r});\n"
        "import importlib; m = importlib.import_module({mod!r});\n"
        "sys.exit(getattr(m, {fn!r})(*json.loads({args!r})))"
    ).format(root=_ROOT, mod=module, fn=function, args=json.dumps(args))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdin=subprocess.DEVNULL)


def check_exactly_once(tag: str, payload: bytes, options: dict,
                       kill_cycles: int = 3, parent_kill: bool = True,
                       device=None, slice_sizes=(7, 3, 11, 2, 29),
                       pause_s: float = 0.005, head: int = 0,
                       parent_kill_after_s: float = 0.2,
                       deadline_s: float = 180.0,
                       work_dir: str = "", ingest: dict = None) -> dict:
    """Grow a file tornly (from its first `head` bytes, a quarter by
    default), kill/restart the consumer `kill_cycles` times (the second
    cycle by a parent SIGKILL), assert the output equals the one-shot
    read on `device` and that the batches tile the file. `ingest`:
    the consumers' ingestor arguments (`consume`). Returns a
    report ({"ok": bool, ...}: rows, batches, cycles, and the surviving
    consumers' launches, drain bytes and seconds, and latencies)."""
    import pyarrow as pa

    from .. import read_cobol
    from .faults import LiveAppender

    work = tempfile.mkdtemp(prefix=f"streamcheck-{tag}-",
                            dir=work_dir or None)
    src = os.path.join(work, "feed.dat")
    ckpt = os.path.join(work, "ckpt")
    out = os.path.join(work, "out.bin")
    head = head or len(payload) // 4
    with open(src, "wb") as f:
        f.write(payload[:head])
    appender = LiveAppender(src, payload[head:], slice_sizes=slice_sizes,
                            pause_s=pause_s).start()
    cycles = 0
    reports = []
    result = {"ok": False, "tag": tag, "src": src,
              "parent_killed": False}
    deadline = time.monotonic() + deadline_s
    t_start = time.monotonic()
    while True:
        crash_after = 2 if cycles < kill_cycles else 0
        report_path = os.path.join(work, f"report{cycles}.json")
        proc = spawn(_MODULE, "consume", src, ckpt, out, crash_after,
                     options, None if device is None else str(device),
                     report_path, ingest or {})
        killed = False
        if parent_kill and cycles == 1:
            # one cycle dies by PARENT SIGKILL at a random instant
            # instead of a self-crash
            time.sleep(parent_kill_after_s)
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                killed = result["parent_killed"] = True
        rc = proc.wait()
        cycles += 1
        if os.path.exists(report_path):
            with open(report_path) as f:
                reports.append(json.load(f))
        if not killed and rc != 0 and not (crash_after and rc == 137):
            print(f"FAIL [{tag}]: consumer exited {rc}")
            return result
        if killed and rc != -signal.SIGKILL:
            print(f"FAIL [{tag}]: killed consumer exited {rc}")
            return result
        if rc == 0 and appender.done:
            break  # drained an idle feed after the appender finished
        if time.monotonic() > deadline:
            print(f"FAIL [{tag}]: kill/restart loop did not drain "
                  f"within {deadline_s:.0f}s (rc={rc})")
            return result
    result["drain_s"] = time.monotonic() - t_start
    ranges = []
    tables = read_output(out, ranges)
    if not tables:
        print(f"FAIL [{tag}]: no output batches survived")
        return result
    got = pa.concat_tables(tables).replace_schema_metadata(None)
    want = read_cobol(src, device=device, **options).to_arrow() \
        .replace_schema_metadata(None)
    if not got.equals(want):
        print(f"FAIL [{tag}]: output != one-shot read "
              f"({got.num_rows} vs {want.num_rows} rows over "
              f"{cycles} kill cycles)")
        return result
    size = os.path.getsize(src)
    expect = 0
    for lo, hi in ranges:
        if lo != expect or hi <= lo:
            print(f"FAIL [{tag}]: batch range {lo}:{hi} after {expect}: "
                  "a gap or a duplicate")
            return result
        expect = hi
    if expect != size:
        print(f"FAIL [{tag}]: batches end at {expect} of {size} bytes")
        return result
    launches = {}
    for r in reports:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    result.update(ok=True, rows=got.num_rows, batches=len(tables),
                  cycles=cycles, bytes=size, launches=launches,
                  reports=reports)
    print(f"ok [{tag}]: {got.num_rows} rows byte-identical across "
          f"{cycles} kill/restart cycles ({len(tables)} batches tiling "
          f"{size} bytes)")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="fixed + VRL, more kill cycles (slow)")
    ap.add_argument("--records", type=int, default=6000)
    ap.add_argument("--device", default=None,
                    help="decode device (default: the CUDA device)")
    args = ap.parse_args(argv)
    fixed_opts = {"copybook_contents": COPYBOOK}
    ok = check_exactly_once(
        "fixed", make_records(args.records), fixed_opts,
        kill_cycles=3 if not args.sweep else 5, device=args.device)["ok"]
    from . import corpus as _corpus
    ok = check_exactly_once(
        "corpus",
        make_corpus_records(args.records if args.sweep
                            else max(2000, args.records // 3)),
        dict(_corpus.fixed_read_options()),
        kill_cycles=2 if not args.sweep else 4,
        device=args.device)["ok"] and ok
    if args.sweep:
        vrl_opts = {"copybook_contents": RDW_COPYBOOK,
                    "is_record_sequence": "true",
                    "generate_record_id": "true"}
        ok = check_exactly_once(
            "vrl", make_rdw_records(args.records), vrl_opts,
            kill_cycles=5, device=args.device)["ok"] and ok
    print("STREAMCHECK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
