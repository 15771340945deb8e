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
2. the framing kernels vs their plain versions on the card, over the
   grid of ``cobrix_tpu_torch.testing.framing_cases`` and a stream of
   records shorter and longer than the tiles: the RDW scan of whole
   images and of windows cut at every phase, from two start positions,
   at three tile sizes (16, 4,096 and the default; status and
   FramingError included), the windowed framing of the reader, and the
   record pack at extents 1-16,064, unaligned offsets, clamped rows and
   start offsets;
3. the fixed-length main path: a file of 1,000,000 exp1 records (1,493
   bytes each) plus 1,024 random records, read with ``read_cobol`` on the
   default device. The fused kernel must launch once per 64 MiB chunk;
   every chunk's fused outputs are held against the plain version on the
   card over the same bytes, and the rows of the first 2,000 records and
   of the random tail against a ``device="cpu"`` decode of the same bytes;
4. the RDW main path: an exp3 file (150,000 records, about 0.81 GB) and
   an exp2 file (2,000,000 records, about 0.13 GB), each read with
   ``read_cobol`` on the default device with the segment field, the
   redefine map C -> STATIC-DETAILS, P -> CONTACTS, Seg_Id levels C and
   P, a fixed prefix and record ids. The scan, pack and fused kernels
   must each launch; the framing is held against a sequential host walk
   of the headers, and the planes and rows of the first records against
   ``read_cobol(device="cpu")`` of the same bytes;
5. the strided OCCURS layout: 50,000 exp3 wide records (16,064 bytes),
   the 'C' records of the exp3 file, kernel against plain on the card;
6. timings at the exp1 chunk and exp3 shapes, each the median of 20
   launches between CUDA events: ``kernel_ms`` (the kernels line's
   ``ms``) times a wrapper call on an idle stream, so the host's launch
   path is in it; ``device_ms`` holds the stream busy before each start
   event, so it is the launch's device time alone. Beside them the plain
   version, the byte bound, the share of it that the device time reaches
   and the achieved GB/s, and the card's name and power limit;
7. one 64 MiB window of each RDW file split into read, H2D, scan,
   segment-id pack and D2H, host work, pack, fused kernel and decode;
   then the framing kernels at the main path's shapes: the window's scan
   (held against the plain version at the default tile and at 4,096),
   split pass by pass with the tiles its chain entered, and at tiles of
   8-64 Ki; the pack of the window's segment-id field and of its widest
   segment; each beside its plain version, its bound (the pack: the
   bytes it reads and writes; the scan: its records' headers and
   outputs, with the whole window's read beside it as
   ``window_read_ms``) and, for the pack, one PyTorch indexing call;
8. where one exp1 chunk's time goes: the file read, then one decode
   under ``torch.profiler`` (device time by kernel and copy, idle share);
9. the pipelined read: the exp1, exp3 and exp2 files each read with
   ``pipeline_workers`` 0 and 2, ``chunk_size_mb=64`` (decoded MB/s of
   each; the auto width runs in phase 11 (b) and the traced read), and
   exp2 once more in more than 50 shards
   (``input_split_records``), so that the pinned staging buffers are
   reused many times. Every read's host planes, record ids, Seg_Id
   columns and sampled rows are hashed: any difference from the
   sequential read fails. Each kernel's launches are counted per read
   (equal where the chunk or shard plan is the same). One pipelined exp1
   read runs under ``cobrix_tpu_torch.profiling.profile_trace``: the
   device's busy time and idle share of the wall, the host-to-device and
   device-to-host copies (one pinned copy back per decoded batch, and
   two more and two up for its table's assembly), the
   streams the work ran on and the copies' overlap with kernels, beside
   the executor's report (overlap factor, peak queue).

10. the device-resident query path (``cobrix_tpu_torch.parallel``), the
   JAX package's three bench legs at their published widths: (a) the
   block query: the exp3 file's 'C' records (``STRATEGY-DETAIL OCCURS
   2000`` of ``NUM1 PIC 9(7) COMP`` and ``NUM2 PIC 9(7) COMP-3``) framed
   on the host, then ``DeviceAggregator.put`` / ``submit`` / ``fetch`` in
   blocks of about 32 MB, for NUM1 and NUM2 and then for NUM1 alone
   (byte-projected): h2d, device-compute and end-to-end MB/s, the
   projection ratio and the bytes copied back; (b) the on-HBM pipeline:
   one copy of the whole image to the card, then ``build_wide_pipeline``
   (the scan's capped mode, the pack, the column gather), ``submit`` and
   ``fetch``: device-pipeline and end-to-end MB/s and the peak device
   memory; (c) ``ShardedColumnarDecoder.decode_stats`` on 1,000,000 exp1
   records in one device-resident batch: device-compute MB/s. The
   aggregate kernel is held against its plain version on the card
   (counts, min and max exact, sums to rtol 1e-12) at the shapes of (a)
   and (b), and first for every value kind (K_I32, K_I64, K_WIDE) and
   scale mode (none, const, dots, digits): the planes of the first 3,000
   exp1 records and of the wide COMP-3 and PIC P rows of
   ``testing/aggregate_cases.py``, each in a block of 4,096 rows and at
   N = 37 rows with `n` a 0-d tensor on the card (37, 20, 0 and 46); (a) equals the sums, counts, min and max of the exp3 read's
   planes (phase 4), (b) equals (a) (sums to rtol 1e-9), the capped scan
   equals the full scan's wide records and, on the whole image, its
   plain version (offsets, lengths and count, exact), the pack at the
   pipeline's shapes equals its plain version, ``decode_stats`` equals
   the valid planes of the exp1 read (phase 3), one ``submit`` of (b)
   runs under ``torch.cuda.set_sync_debug_mode("error")`` and a traced
   ``submit`` and ``fetch`` make no HtoD and one DtoH copy (a trace with
   no device events fails). The aggregate kernel is timed at both
   shapes beside its plain version and its byte bound: with fresh
   outputs as ``submit`` makes them (``ms``, ``device_ms``) and alone on outputs
   made before (``kernel_device_ms``), beside an empty
   launch and one ``torch.sum`` over the i32 plane (a bandwidth
   reference, not the same function), and so are every numeric field of
   the 3,000 exp1 records (190 columns of every kind and mode); and the
   projection's gather after the pack alone.
11. Arrow output and the record-shaping options (pyarrow's and pandas'
   versions first): (a) the phase 3 exp1 file and the phase 4 exp3 and
   exp2 files read on the default device, then ``to_arrow()``: read and
   ``to_arrow`` seconds, MB/s over both, the table's rows, columns and
   bytes; the tables of the first records (exp1: the first 2,000 and
   the random tail; RDW: the phase 4 prefixes) equal a
   ``device="cpu"`` read's (schema with metadata; structs flattened,
   floats by bit pattern); (b) each file read pipelined (workers 2 and
   auto, ``chunk_size_mb=64``) with a ``batch_callback``: the tables
   delivered, in index order, equal ``to_arrow()`` without its
   metadata; MB/s beside phase 9's same reads; (c) an ASCII
   fixed-length file (``generate_ascii``, 3,300,000 records, 258 MiB),
   200,000 exp1 records with a 4-byte record prefix, a 3-byte record
   suffix, a 100-byte file header and a torn 700-byte tail, read with
   ``record_start_offset``, ``record_end_offset``,
   ``file_start_offset``, ``generate_record_id`` and
   ``with_input_file_name_col``, and a fixed-length multisegment file
   (``generate_fixed_segments``, 2,000,000 records) with
   ``segment_field`` and its redefine map: each table equals a
   ``device="cpu"`` read's of the same file. ``fused_decode`` and
   ``arrow_scalars`` must launch on every phase 11 read (the tables are
   built by the Arrow assembly kernels, in ``to_arrow`` or the pipelined
   assemble stage), and each assembly kernel on one of them; their
   launches join the kernels line's ``launches_by_path``.

12. the permissive record error policies and the generic per-record
   reader: (a) the phase 4 exp2 file with seven
   fault sites (``testing/faults.py``: three zeroed headers, the first
   just before the first 64 MiB window's end; a header declaring 65,535
   bytes; a 64-byte garbage splice; a flipped header bit; a torn tail)
   and (b) the phase 4 exp3 file with a zeroed header within the resync
   window of the first window's end and a garbage run across the second
   window's end, each read with the segment field and redefine map:
   fail_fast raises at the first site's offset with its hex snapshot;
   under ``permissive`` (with ``corrupt_record_column``) and
   ``drop_malformed`` the device framing (``frame_windows``: the scan
   relaunched on the same image after each resync) equals the plain
   ``rdw_scan_permissive`` over the same host bytes (offsets, lengths,
   reasons, ledger); the read's ledger JSON equals the plain scan's; the
   rows within 3 records of every site and ledger entry and the first
   and last 1,000 rows equal ``device="cpu"`` reads of the records
   there, whose ledger entries are the same; the reads in
   31,250-record index shards, sequential and pipelined (2 workers),
   equal each other (tables, ledgers) and the whole-file read (rows,
   entries); (c) the phase 3 exp1 file with a 700-byte torn tail under
   the three policies (fail_fast names ``permissive``; the last row kept
   with its reason, or dropped; the ledger entry; the last 1,000 rows
   against a CPU read); (d) the generic framings on the card: 50,000
   exp3 records with big-endian RDWs read through ``RECORD-LENGTH PIC
   9(4) COMP`` (clean, and permissive with three length fields broken),
   250,000 text lines (LF and CRLF, ``encoding=ascii``), 250,000
   ``generate_custom_rdw`` records through a custom header parser and
   through a custom record extractor (``testing/custom_framing.py``), and
   6,000 records of a trailing ``OCCURS 1 TO 2000 DEPENDING ON`` table
   (``variable_size_occurs``): the first and last 1,000 rows against CPU
   reads. Before them, the cost of the policies on the clean exp2, exp3
   and exp1 files in turns (fail_fast, permissive, permissive,
   fail_fast): the same scan launches. Every read prints its MB/s, its
   frame and decode seconds, its launches and its ledger counts.

13. hierarchical (segment-children) reads and the host row walk: (a) the
   phase 4 exp3 file with CONTACTS under STATIC-DETAILS and record ids,
   decoded once on the card at the full plan (the scan, pack and fused
   kernels must each launch) and read with ``to_arrow``, sequential and
   pipelined (2 workers, shards on roots): the pipelined table equals
   the sequential one, ``Record_Id`` is the flush trigger's record
   index, the first and last 500 roots equal ``device="cpu"`` reads of
   their records, and ``to_rows()`` of a 3,000-record prefix equals its
   table and a CPU read; (b) the 7-segment hierarchy
   (``generate_hierarchical``, 60,000 companies in 8 parts of seeds
   100-107, about 80 MB), whose roots cross a 64 MiB window: its table
   equals a CPU read's, the pipelined table the sequential one, and the
   rows and JSON lines of its first 5,000 companies (about 6.7 MB) a
   CPU read's; (c) the host row walk, on the host: the first 5,000
   companies read with ``select``, and 100,000 records of a DEPENDING
   ON table followed by a trailer (``generate_dynamic_occurs``), against
   CPU reads. Every read prints its MB/s and rows a second, its frame /
   decode / assemble seconds, its launches, the peak device memory, the
   host RSS and ``assembly_stats`` (columnar, no bail, on (a) and (b)).
   The assembly kernels must launch on (a) and (b).

14. the Arrow assembly (``ops.arrow_assemble``, ``csrc/arrow_assemble
   .cu``): (a) each of its three kernels against its plain version from
   the same state, every byte of the output buffer and the tile bases
   (the lengths kernel's look-back scratch is its own and is not
   compared; its plain version is the lengths, then the scan of the
   tile sums), over the grid of ``testing/arrow_cases.py`` (every
   kind and decimal mode; shifts 0, 18, 19, 38 and out of range;
   precisions that overflow; all-valid, all-null and mixed validity;
   hidden rows and row tables; 1, 31, 32, 33, 257, 4,097 and 44,949
   rows; 2,000-slot arrays, as per-slot planes and as evenly spaced
   slots of column-major fused planes; strings of uint8 and uint16 code
   points, non-ASCII, blank and empty, under each trim, in string tiles
   staged in shared memory and in tiles too wide for it), one string
   array of 4,000,000 rows x 16 code points (64 MB, 15,625 tiles: many
   waves of the look-back), the exp1 chunk's and
   the exp3 'C' batch's (4,143 rows of the 2,000-slot plane) own plans,
   and the assemblies of an exp2 prefix, the 7-segment hierarchy and
   an exp3 hierarchy prefix (masks, positions, a joined batch's staged
   planes); (b) the tables of phases 11 and 13 (a), built by these
   kernels, equal the CPU reads' there; (c) at the exp1 chunk, the
   exp3 'C' batch and the 4,000,000-string array: each kernel's ``ms``
   and ``device_ms``, its plain version's time on the card, the bytes it
   must move over this run's data and that bound's share, and beside
   the lengths kernel one ``torch.cumsum`` over the same tile sums (a
   yardstick of the scan alone, not the function; the port never calls
   it); at the two batches the plan's host time, the copies up and
   back, one whole assembly and the batch's table; and where the
   ``to_arrow`` of exp1,
   exp3, exp2 and the exp3 hierarchy goes on one thread (the schema
   walk, the plans, the assemblies with their copies, the rest on the
   host); (d) the exp3 hierarchy's indexed
   read and exp1's read + ``to_arrow`` at ``parallelism`` 1 and at its
   default, min(16, cpu_count): equal tables, seconds.

15. the I/O plane (``cobrix_tpu_torch.io``): (a) compressed feeds: the
   phase 3 exp1 file (its phase 3 bytes) and the phase 4 exp3 file as
   multi-member gzip and the exp2 file as xz, one member per 4 MiB
   compressed on a thread pool at the fastest level, each read on the
   default device sequentially with no ``cache_dir`` (one decompressing
   stream in 64 MiB chunks or windows), and exp1 and exp3 pipelined (2
   workers, ``chunk_size_mb=64``, a ``cache_dir``, 4 MiB decompressed
   blocks), cold, warm, then warm sequentially. Every read hashes equal
   to the raw file's phase 9 read (planes, record ids, Seg_Id columns,
   sampled rows) and launches the fused, scan and pack kernels as that
   read did (a warm pipelined read less the index pass it skips); the
   warm reads inflate nothing (``compressed_bytes_in`` 0) and serve
   every block from the cache (the warm sequential read: exactly the
   blocks); one ``to_arrow`` of the gzip exp3 read equals phase 11's
   table. (b) the exp2 file served through a registered
   ``ByteRangeSource``, plain, and through ``ChaosSource`` failing every
   7th backend read with ``io_retry_*``, ``prefetch_blocks=4``,
   ``io_block_mb=8`` and a ``cache_dir``, cold then warm: equal hashes,
   the injected failures retried and ledgered, the warm read fetching 0
   backend bytes and loading the sparse index (no index pass). (c) the
   gzip exp2 feed with its last member torn, read permissive on the card
   and on the CPU (the segment id alone decoded there): equal row counts
   and ledgers. Each read prints its
   decompressed MB/s beside the raw read's, ``inflate_s``, the wire and
   decompressed bytes, the compression ratio, and the card's name and
   power limit. fsspec and ``zstandard`` are not used (the card's
   machine has neither).

16. filter pushdown (``cobrix_tpu_torch.query``): (a) the phase 3 exp1
   file read sequentially and pipelined (2 workers, ``chunk_size_mb=64``)
   under three filters: a COMP-3 field and a string ``isin`` that keep
   5-20% of the records, one that keeps every record (nulls included)
   and one that keeps none. Each table equals the unfiltered card read's
   table filtered with pyarrow, and its first rows a CPU read's of the
   first 5,000 records' bytes; the pruning counters agree with it, and
   the fused decode and the pack launch once a chunk for stage 1 and
   once more a chunk that keeps records (stage 2). (b) the phase 4 exp3
   file, sequential and pipelined, with a segment conjunct and a value
   predicate (against the unfiltered read filtered with pyarrow and a
   CPU read of the records in its first 16 MB), and the exp2 file with a
   segment conjunct alone, whose launches and table are the
   ``segment_filter`` option's read's (no stage 1). (c) the exp3 file as
   a hierarchy with a value filter: the residual route, against the
   unfiltered hierarchical read filtered with pyarrow. (d)
   ``query.dataset`` over exp1: ``count_rows`` and ``aggregate`` with the
   (a) filter as a pyarrow expression, against pyarrow over the
   unfiltered table. (e) where one exp1 chunk's filtered read goes: H2D,
   stage 1's decode, its Arrow arrays, the predicate, stage 2's decode,
   beside the unfiltered decode of the chunk. Each read prints its MB/s
   beside the unfiltered read's, its counters and launches; every
   kernel's ``launches_by_path`` gets a ``pushdown`` path.
17. the observability plane (``cobrix_tpu_torch.obs``, ``explain``):
   (c) ``explain`` over the phase 3 exp1 file before any read: it
   renders, its dict survives JSON, it launches nothing. (d) the exp1
   read with attribution off: no field-cost timer call and one CUDA
   synchronize a chunk (counted by wrapping ``torch.cuda.Stream``'s,
   ``Event``'s and the device's ``synchronize`` in this script only);
   its planes and table are the references. (a) exp1 read with
   ``explain=True``, ``trace_file`` and a ``progress_callback``, then
   ``to_arrow``, sequential and pipelined (2 workers,
   ``chunk_size_mb=64``): planes, table and fused launches equal the
   untraced read's; the sequential read makes no more synchronizes than
   (d); the decode plane is within 15% of the decode stage's busy time;
   the assemble plane is positive; the trace loads in
   ``tools/traceview.py`` (``load_events``, ``summarize``), with the
   chunk spans under the scan root and the stage spans under them;
   progress is monotonic and ends at the file's bytes with
   ``done=True``; ``prometheus_text()`` has the scan counters. (b) the
   phase 4 exp3 file, sequential, with ``trace_file`` and
   ``field_costs``: the shard span with its frame and decode spans, the
   untraced read's scan, pack and fused launches and planes, the decode
   plane's 15% anchor. Each read prints its MB/s beside the untraced
   read's; every kernel's ``launches_by_path`` gets an ``obs`` path.
18. the statistics plane (``cobrix_tpu_torch.stats``): (a) the phase 3
   exp1 file read with ``collect_stats`` and a fresh ``cache_dir`` at the
   default 4 MB grid (357 chunks of 2,809 records): the profiling pass
   launches the fused kernel and each assembly kernel once a chunk
   (counted as the read's launches less its stats-off twin's), a second
   collecting read loads the profile and launches nothing more than the
   twin, and the profile of the first 64 MiB of records on the card
   equals the CPU's (``to_payload`` value for value); the pass's seconds
   print apart from the read's. (b) 8,000,000 TXN records
   (``testing/corpus.write_fixed_corpus``, TXN-ID rising, 67 chunks)
   collected, then read with ``use_stats`` under ``TXN_ID == 4000000``
   (>= 90% of the chunks skipped; the filter's stages launch on the kept
   chunks only) and ``STATUS == 'A'`` (nothing provable, nothing
   skipped), sequential and pipelined (2 workers): each table equals its
   stats-off twin's. (c) 1,000,000 companies
   (``write_multiseg_corpus``) in 4 MB index shards, collected, then read
   under a selective and an impossible ``COMPANY_ID`` filter, sequential
   and pipelined: the selective reads skip some shards, the impossible
   ones every shard with no scan, pack or fused launch (the sequential
   one is ROADMAP C10 at full size); tables equal the twins'. (d)
   ``query.dataset(..., use_stats="true").aggregate`` over (b)'s file
   equals the decode path's answer, types included, with no launch.
   Every read prints its MB/s beside its twin's; every kernel's
   ``launches_by_path`` gets a ``stats`` path.

Every phase prints its seconds (``[phases]``), and a whole run prints
them again as one ``[phases] {...}`` JSON line before the result lines.
Every failure exits non-zero. The last three lines are the card's name
and power limit, the kernels JSON and ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the package beside this
file, it exits 2 and prints no result.

``--cpu-rehearsal`` runs the same phases at a small size on the CPU, with
the plain versions in place of the kernel, and exits 3 without the result
lines: it checks the script's paths, not the card. ``--phases 13`` (or
``12``, ``14``, ``15``, ``16``, ``17``, ``18``, or several) runs the
environment, phase 4 (phase 14 also phases 3 and 5, phases 15-18 also
phase 3) and the phases named, and also exits 3 without the result
lines. ``--cpu-rehearsal --phases 18`` rehearses phase 18 alone.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import resource
import shutil
import signal
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
FRAMING_SOURCE = "cobrix_tpu_torch/csrc/rdw_framing.cu"
# the XLA device framing the two framing kernels replace
SCAN_REPLACES = "cobrix_tpu/ops/device_framing.py:128"
PACK_REPLACES = "cobrix_tpu/ops/device_framing.py:65"
# the RDW main path's options (the JAX package's spellings)
RDW_OPTIONS = {
    "is_record_sequence": "true", "segment_field": "SEGMENT-ID",
    "segment_id_level0": "C", "segment_id_level1": "P",
    "segment_id_prefix": "SMOKE", "generate_record_id": "true",
    "redefine-segment-id-map:0": "STATIC-DETAILS => C",
    "redefine-segment-id-map:1": "CONTACTS => P"}
# phase 12's RDW options: the segment routing alone, so that a read of a
# slice of records gives the same rows as the whole file's read there
P12_SEG = {"segment_field": "SEGMENT-ID",
           "redefine-segment-id-map:0": "STATIC-DETAILS => C",
           "redefine-segment-id-map:1": "CONTACTS => P"}
P12_RDW = dict(is_record_sequence="true", **P12_SEG)
# phase 13's exp3 hierarchy: CONTACTS under STATIC-DETAILS
P13_EXP3 = {
    "is_record_sequence": "true", "segment_field": "SEGMENT-ID",
    "generate_record_id": "true",
    "redefine-segment-id-map:0": "STATIC-DETAILS => C",
    "redefine-segment-id-map:1": "CONTACTS => P",
    "segment-children:0": "STATIC-DETAILS => CONTACTS"}
# the kernels of the reads, the query path's aggregate and the Arrow
# assembly's three
READ_KERNELS = ("fused_decode", "rdw_scan", "pack_records")
ARROW_KERNELS = ("arrow_scalars", "arrow_str_lengths", "arrow_str_copy")
KERNELS = READ_KERNELS + ("aggregate",) + ARROW_KERNELS
ARROW_SOURCE = "cobrix_tpu_torch/csrc/arrow_assemble.cu"
# the host C++ of the JAX package's native decode->Arrow routes each
# assembly kernel replaces (no TPU kernel)
ARROW_REPLACES = {
    "arrow_scalars": "cobrix_tpu/native/columnar.cpp:518",
    "arrow_str_lengths": "cobrix_tpu/native/framing.cpp:600",
    "arrow_str_copy": "cobrix_tpu/native/framing.cpp:600"}
AGG_SOURCE = "cobrix_tpu_torch/csrc/aggregate.cu"
# the reduction body of DeviceAggregator._build the aggregate kernel replaces
AGG_REPLACES = "cobrix_tpu/parallel/query.py:123"
# the query path's exp3 fields (bench.py run_device_query)
QUERY_FIELDS = ("NUM1", "NUM2")
# the aggregate kernel's value kinds and scale modes (ops/aggregate.py)
AGG_KINDS = {0: "K_I32", 1: "K_I64", 2: "K_WIDE"}
AGG_MODES = {0: "none", 1: "const", 2: "dots", 3: "digits"}
# phases `--phases` can run alone (after the environment and phase 4)
PHASES = {"12": "phase_generic", "13": "phase_hierarchical",
          "14": "phase_assembly", "15": "phase_io", "16": "phase_pushdown",
          "17": "phase_obs", "18": "phase_stats"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# One part of a generated RDW file, written by a child interpreter:
# argv = checkout, kind, records, seed, path
WRITE_PART = """
import sys
sys.path.insert(0, sys.argv[1])
from cobrix_tpu_torch.testing import generators
kind, n, seed, path = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
data = getattr(generators, "generate_" + kind)(n, seed=seed)
with open(path, "wb") as f:
    f.write(data)
"""


def run_children(argvs, timeout):
    """Run the commands side by side and wait for all of them; any child
    still running when this returns or raises is killed and reaped."""
    procs = []
    try:
        for argv in argvs:
            procs.append(subprocess.Popen(
                argv, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE))
        deadline = time.monotonic() + timeout
        for argv, proc in zip(argvs, procs):
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            check(proc.returncode == 0,
                  f"child {argv[-1]} exited {proc.returncode}: "
                  f"{err.decode(errors='replace')[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def child_pids():
    """Pids of this process's living children (Linux /proc)."""
    me, pids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the field after the command's closing parenthesis is the state,
        # then the parent's pid
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) == me and fields[0] != "Z":
            pids.append(int(entry))
    return pids


def stop_children():
    """Kill and reap every child still running: the script leaves no
    process behind, whatever a phase started."""
    left = child_pids()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    return left


def host_walk(data):
    """Payload offsets and lengths of an RDW file (little-endian headers,
    no adjustment), one record at a time: the sequential reference."""
    offsets, lengths, pos, size = [], [], 0, len(data)
    while pos + 4 <= size:
        length = data[pos + 2] | (data[pos + 3] << 8)
        offsets.append(pos + 4)
        lengths.append(min(length, size - pos - 4))
        pos += 4 + length
    return offsets, lengths


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
        self.only = [p for p in (args.phases or "").split(",") if p]
        self.device = torch.device("cpu" if self.rehearsal else "cuda")
        self.n_exp1 = 3000 if self.rehearsal else 1_000_000
        self.n_tail = 64 if self.rehearsal else 1024
        self.n_exp3 = 30 if self.rehearsal else 50_000
        self.grid_rows = 64 if self.rehearsal else 4096
        self.n_rdw = ({"exp3": 300, "exp2": 3000} if self.rehearsal
                      else {"exp3": 150_000, "exp2": 2_000_000})
        # records whose planes and rows are held against a CPU read
        self.n_check = ({"exp3": 120, "exp2": 1500} if self.rehearsal
                        else {"exp3": 3000, "exp2": 20_000})
        self.max_err = dict.fromkeys(KERNELS, 0.0)
        self.agg_rel_err = 0.0  # the aggregate's sums: largest relative error
        self.launches = {}   # path -> kernel -> launches on that path
        # phase 9's raw reads by file: digest, launches, MB/s (phase 15's
        # references)
        self.raw_reads = {}
        self.phase_secs = {}  # phase -> seconds
        self.tmp = tempfile.mkdtemp(prefix="cobrix_smoke_")

    def sync(self):
        if not self.rehearsal:
            self.torch.cuda.synchronize()

    # -- comparisons ---------------------------------------------------

    def same(self, a, b, what, kernel="fused_decode"):
        """Exact equality of two tensors or arrays (dtype included);
        records the largest absolute difference for `kernel`."""
        np = self.np
        if isinstance(a, self.torch.Tensor):
            a = a.cpu().numpy()
        if isinstance(b, self.torch.Tensor):
            b = b.cpu().numpy()
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        if not np.array_equal(a, b):
            diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
            self.max_err[kernel] = max(self.max_err[kernel],
                                       float(np.nanmax(diff)))
            raise SmokeFailure(f"{what}: kernel and plain version differ "
                               f"at {int((a != b).sum())} places")

    def same_on_card(self, a, b, what, kernel):
        """`same` for large tensors: equal on their device, else copied
        back and compared by `same`, which raises."""
        if (a.dtype == b.dtype and a.shape == b.shape
                and self.torch.equal(a, b)):
            return
        self.same(a, b, what, kernel)

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
        launches = fused_decode.launches
        self.launches["exp1"] = {"fused_decode": launches}
        log(f"[main] {self.card}: read_cobol: {len(data)} records, "
            f"{len(data.batches)} "
            f"chunks in {secs:.3f} s = {size / secs / 1e6:.1f} MB/s "
            f"end to end; fused kernel launches {launches}")
        check(len(data) == self.n_exp1 + self.n_tail, "record count")
        check(len(data.batches) == n_chunks, "chunk count")
        if not self.rehearsal:
            check(launches == n_chunks,
                  f"fused kernel launched {launches} times for "
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
        self.exp1_valid = self._valid_counts(data.batches, self.n_exp1)
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
        self.exp1_path = path  # read again by the pipeline phase

    def phase_framing_grid(self):
        """The scan and pack kernels against their plain versions on the
        card over the shared grid."""
        np, torch = self.np, self.torch
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.reader import var_len_reader as vlr
        from cobrix_tpu_torch.reader.diagnostics import FramingError
        from cobrix_tpu_torch.testing.framing_cases import (
            WINDOWS, pack_case, rdw_stream, scan_cases)

        def outcome(fn):
            try:
                offsets, lengths = fn()
            except FramingError as e:
                return ("error", str(e), e.offset, e.reason, e.header)
            return ("ok", list(offsets), list(lengths))

        def windowed(image, big_endian, adj, header, footer, device):
            offs, lens = [], []
            for base, _, o, ln in vlr.frame_windows(
                    io.BytesIO(image), len(image), device, big_endian,
                    adj, header, footer):
                offs.extend((base + o.cpu().numpy()).tolist())
                lens.extend(ln.cpu().tolist())
            return offs, lens

        cases = dict(scan_cases())
        # records shorter and longer than the tiles: entries that skip
        # tiles, links that land on tile ends, stops inside tiles
        rng = np.random.default_rng(21)
        long_short = rdw_stream(np.where(
            rng.random(400) < 0.2, rng.integers(5000, 40000, 400),
            rng.integers(1, 200, 400)).tolist(), seed=21)
        cases["long_and_short"] = (long_short, False, 0, 0, 0)
        tiles = (16, 4096, df.SCAN_TILE)
        windows = 0
        saved = vlr.READ_WINDOW_BYTES
        try:
            for name, (image, big_endian, adj, header, footer) in \
                    sorted(cases.items()):
                t = torch.from_numpy(np.frombuffer(image, np.uint8).copy())
                dev = t.to(self.device)
                # the record area and first header, as the reader's
                # frame_windows takes them
                end = (len(image) - footer if 0 < footer < len(image)
                       else len(image))
                start = header if header > 4 else 0
                for lo, hi in [(start, end)] + [(start, start + w)
                                                for w in WINDOWS[:-1]]:
                    if hi > end or lo > hi:
                        continue
                    for last in ((True,) if hi == end else (False, True)):
                        for at in sorted({0, min(5, hi - lo)}):
                            b = df.scan_window_plain(dev[lo:hi], at, last,
                                                     big_endian, adj)
                            for tile in tiles:
                                a = df.scan_window(dev[lo:hi], at, last,
                                                   big_endian, adj, tile)
                                what = (f"scan {name} [{lo}:{hi}] from {at} "
                                        f"tile {tile}")
                                for x, y, key in zip(a[:2], b[:2],
                                                     ("offsets", "lengths")):
                                    self.same(x, y, f"{what} {key}",
                                              "rdw_scan")
                                check(a[2] == b[2],
                                      f"{what} status {a[2]} != {b[2]}")
                                windows += 1
                # the reader's windowed framing on the card against the
                # same framing over the plain scan
                for w in WINDOWS:
                    vlr.READ_WINDOW_BYTES = w
                    want, got = (outcome(lambda: windowed(
                        image, big_endian, adj, header, footer, d))
                        for d in ("cpu", self.device))
                    check(got == want, f"windowed scan {name} window {w}")
        finally:
            vlr.READ_WINDOW_BYTES = saved
        image, offsets, lengths = pack_case()
        rng = np.random.default_rng(5)
        big = rng.integers(0, 256, size=1 << 20, dtype=np.uint8)
        big_offs = rng.integers(-8, (1 << 20) + 8, size=512).astype(np.int64)
        big_lens = rng.integers(-2, 20000, size=512).astype(np.int64)
        packs = 0
        for img, offs, lens in [(image, offsets, lengths),
                                (big, big_offs, big_lens)]:
            dev = torch.from_numpy(img).to(self.device)
            o = torch.from_numpy(offs).to(self.device)
            ln = torch.from_numpy(lens).to(self.device)
            for extent in (1, 5, 16, 17, 60, 64, 333, 16064):
                for start in (0, 3, 7):
                    for x in (dev, dev[1:]):  # unaligned image too
                        a = df.pack_records(x, o, ln, extent, start)
                        b = df.pack_records_plain(x, o, ln, extent, start)
                        self.same(a, b, f"pack extent {extent} start "
                                  f"{start}", "pack_records")
                        packs += 1
        self.sync()
        log(f"[framing] {len(cases)} scan cases, {windows} windows at tiles "
            f"{tiles} and the reader's framing at {len(WINDOWS)} window "
            f"sizes; {packs} packs: kernels == plain, exact (status and "
            f"errors included)")

    def _write_rdw(self, kind, n, seed0):
        """An RDW file of `n` generated records, in parts written by
        child interpreters side by side and joined in order."""
        parts = min(8, os.cpu_count() or 1, max(1, n // 1000))
        jobs, done = [], 0
        for k in range(parts):
            m = (n - done) // (parts - k)
            jobs.append((kind, m, seed0 + k,
                         os.path.join(self.tmp, f"{kind}.{k}.part")))
            done += m
        run_children([[sys.executable, "-c", WRITE_PART, HERE, job[0],
                        str(job[1]), str(job[2]), job[3]] for job in jobs],
                     timeout=600)
        path = os.path.join(self.tmp, f"{kind}.dat")
        with open(path, "wb") as out:
            for job in jobs:
                with open(job[3], "rb") as f:
                    shutil.copyfileobj(f, out, 16 << 20)
                os.remove(job[3])
        return path

    def phase_rdw(self):
        """The RDW main path: read_cobol over an exp3 and an exp2 file on
        the default device, each kernel's launches counted on each read."""
        np, torch = self.np, self.torch
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import fused_decode
        from cobrix_tpu_torch.reader import var_len_reader as vlr
        from cobrix_tpu_torch.testing.generators import (EXP2_COPYBOOK,
                                                         EXP3_COPYBOOK)

        if self.rehearsal:
            vlr.READ_WINDOW_BYTES = 256 * 1024  # several windows
        counters = {"fused_decode": fused_decode, "rdw_scan": df.scan_window,
                    "pack_records": df.pack_records}
        self.rdw_files, self.rdw_walk, self.rdw_e2e = {}, {}, {}
        for kind, cb, seed0 in [("exp3", EXP3_COPYBOOK, 11),
                                ("exp2", EXP2_COPYBOOK, 200)]:
            t0 = time.perf_counter()
            path = self._write_rdw(kind, self.n_rdw[kind], seed0)
            size = os.path.getsize(path)
            log(f"[rdw] wrote {self.n_rdw[kind]} {kind} records ({size} "
                f"bytes) in {time.perf_counter() - t0:.1f} s")
            kw = {"device": "cpu"} if self.rehearsal else {}
            for fn in counters.values():
                fn.launches = 0
            self.sync()
            t0 = time.perf_counter()
            data = read_cobol(path, copybook_contents=cb, **RDW_OPTIONS,
                              **kw)
            self.sync()
            secs = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            self.launches[f"rdw_{kind}"] = launches
            self.rdw_e2e[kind] = (size, secs)
            log(f"[rdw] {self.card}: {kind} read_cobol: {len(data)} records "
                f"in {secs:.3f} s = {size / secs / 1e6:.1f} MB/s end to "
                f"end; launches {json.dumps(launches)}")
            if not self.rehearsal:
                for k, v in launches.items():
                    check(v > 0, f"{k} never launched on the {kind} read")
            with open(path, "rb") as f:
                raw = f.read()
            t0 = time.perf_counter()
            walk = host_walk(raw)
            log(f"[rdw] host walk of {len(walk[0])} headers in "
                f"{time.perf_counter() - t0:.1f} s")
            self.rdw_files[kind] = path
            self.rdw_walk[kind] = (raw, walk)
            (result,) = data.results
            check(result.records_framed == len(walk[0]) == self.n_rdw[kind]
                  == len(data), f"{kind}: records framed "
                  f"{result.records_framed}, walked {len(walk[0])}")
            offs, lens = [], []
            with open(path, "rb") as f:
                for base, _, o, ln in vlr.frame_windows(
                        f, size, self.device, False, 0):
                    offs.append(base + o.cpu().numpy())
                    lens.append(ln.cpu().numpy())
            check(np.array_equal(np.concatenate(offs), walk[0])
                  and np.array_equal(np.concatenate(lens), walk[1]),
                  f"{kind}: device framing differs from the host walk")
            self._check_prefix(kind, cb, data, raw, walk)
            if kind == "exp3":
                self.exp3_planes = self._plane_stats([
                    seg.batch for seg in data.results[0].segments
                    if seg.active == "STATIC_DETAILS"], QUERY_FIELDS)
            del data, raw
        log(f"[rdw] framing == host walk; planes and rows of the first "
            f"records == device='cpu' read")

    def _check_prefix(self, kind, cb, data, raw, walk):
        """Planes and rows of the first records of a device read against
        read_cobol(device="cpu") over a file of just those records."""
        np = self.np
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.reader.result import FileResult

        k = self.n_check[kind]
        offsets, lengths = walk
        end = offsets[k - 1] + lengths[k - 1]
        path = os.path.join(self.tmp, f"{kind}.prefix.dat")
        with open(path, "wb") as f:
            f.write(raw[:end])
        want = read_cobol(path, copybook_contents=cb, device="cpu",
                          **RDW_OPTIONS).results[0]
        (got,) = data.results
        # the device read's batches that hold the first k records
        head = [seg for seg in got.segments if seg.positions[0] < k]
        actives = {seg.active for seg in want.segments}
        for active in actives:
            mine = [seg for seg in head if seg.active == active]
            ref = [seg for seg in want.segments if seg.active == active]
            pos = np.concatenate([seg.positions for seg in ref])
            m = len(pos)
            check(np.array_equal(np.concatenate(
                [seg.positions for seg in mine])[:m], pos),
                f"{kind} {active}: positions differ")
            decoder = ref[0].batch.decoder
            for col in range(len(decoder.plan.columns)):
                for key in ref[0].batch.column_arrays(col):
                    a = np.concatenate([seg.batch.column_arrays(col)[key]
                                        for seg in mine])[:m]
                    b = np.concatenate([seg.batch.column_arrays(col)[key]
                                        for seg in ref])
                    self.same(a, b, f"{kind} {active} column {col} {key}")
        part = FileResult(n_rows=0, file_id=got.file_id, policy=got.policy,
                          generate_record_id=got.generate_record_id,
                          segments=head)
        rows = want.to_rows()
        check(part.to_rows()[:len(rows)] == rows, f"{kind}: rows of the "
              f"first {k} records differ from the CPU read")
        log(f"[rdw] {kind}: planes of {len(actives)} segments and rows of "
            f"the first {k} records == device='cpu' read")
        os.remove(path)

    def phase_exp3(self):
        np, torch = self.np, self.torch
        from cobrix_tpu_torch import ColumnarDecoder, parse_copybook
        from cobrix_tpu_torch.ops.fused_decode import fused_decode, fused_decode_plain
        from cobrix_tpu_torch.testing.generators import (EXP3_COPYBOOK,
                                                         generate_exp3)

        t0 = time.perf_counter()
        # the wide 'C' records of the RDW phase's exp3 file first
        data, (offsets, lengths) = self.rdw_walk["exp3"]
        wide = [data[o:o + n] for o, n in zip(offsets, lengths)
                if n > 1000][:self.n_exp3]
        seed = 1011
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
            f"{self.launches['exp1']['fused_decode']}")

    def phase_rdw_timings(self):
        """The framing kernels at the RDW main path's shapes, and one
        window of each file split into the reader's steps."""
        np, torch = self.np, self.torch
        from cobrix_tpu_torch.api import parse_options
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import fused_decode
        from cobrix_tpu_torch.reader import var_len_reader as vlr
        from cobrix_tpu_torch.reader.vrl_reader import \
            resolve_segment_id_field
        from cobrix_tpu_torch.testing.generators import (EXP2_COPYBOOK,
                                                         EXP3_COPYBOOK)

        self.rdw_timings = {}
        for kind, cb in [("exp3", EXP3_COPYBOOK), ("exp2", EXP2_COPYBOOK)]:
            raw = self.rdw_walk[kind][0]
            L = min(vlr.READ_WINDOW_BYTES, len(raw))
            last = L == len(raw)
            split = {}

            def lap(key, t0):
                self.sync()
                split[key] = split.get(key, 0.0) + (
                    time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            host = np.empty(L, dtype=np.uint8)
            with open(self.rdw_files[kind], "rb") as f:
                f.readinto(memoryview(host))
            lap("read_ms", t0)
            t0 = time.perf_counter()
            image = torch.from_numpy(host).to(self.device)
            lap("h2d_ms", t0)
            t0 = time.perf_counter()
            offs_d, lens_d, status = df.scan_window(image, 0, last)
            lap("scan_ms", t0)
            t0 = time.perf_counter()
            lens = lens_d.cpu().numpy()
            lap("lengths_d2h_ms", t0)
            reader = vlr.VarLenReader(cb, parse_options(RDW_OPTIONS),
                                      device=self.device)
            seg_field = resolve_segment_id_field(reader.params,
                                                 reader.copybook)
            t0 = time.perf_counter()
            field = df.pack_records(image, offs_d, lens_d, 5, 0)
            ids = reader._segment_ids_vectorized(field.cpu().numpy(), lens,
                                                 seg_field)
            lap("segment_ids_ms", t0)
            t0 = time.perf_counter()
            by_active = {a: np.nonzero(ids.mask_of_mapped(
                reader.segment_redefine_map, a))[0]
                for a in set(ids.map_uniq(reader.segment_redefine_map))}
            lap("host_select_ms", t0)
            shapes = {}
            for active, pos in sorted(by_active.items()):
                dec = reader._decoder_for_segment(active)
                idx = torch.from_numpy(pos).to(self.device)
                t0 = time.perf_counter()
                o, ln = offs_d[idx], lens_d[idx]
                packed = df.pack_records(image, o, ln, dec.plan.max_extent)
                lap("pack_ms", t0)
                if dec.fused is not None:
                    t0 = time.perf_counter()
                    planes = fused_decode(packed, dec.fused)
                    lap("fused_ms", t0)
                    t0 = time.perf_counter()
                    {k: v.cpu() for k, v in planes.items()}
                    lap("fused_planes_d2h_ms", t0)
                t0 = time.perf_counter()
                dec.decode_raw(image, o, lens[pos])
                lap("decode_raw_ms", t0)
                shapes[active] = (o, ln, dec.plan.max_extent, len(pos))
            split.update(window_bytes=L, records=int(offs_d.numel()),
                         segments={a: len(p) for a, p in by_active.items()})
            log(f"[rdw-time] {self.card}: {kind} window split: "
                f"{json.dumps(split)}")

            # the scan at this window, kernel against plain, at the
            # default tile and at one smaller than exp3's records
            plain = df.scan_window_plain(image, 0, last)
            for a, b in zip((offs_d, lens_d), plain[:2]):
                self.same(a, b, f"{kind} window scan", "rdw_scan")
            check(plain[2] == status, f"{kind} window scan status")
            small = df.scan_window(image, 0, last, tile=4096)
            for a, b in zip(small[:2], plain[:2]):
                self.same(a, b, f"{kind} window scan at tile 4096",
                          "rdw_scan")
            check(small[2] == status, f"{kind} window scan status at tile "
                  f"4096")
            del small
            n = int(offs_d.numel())
            # what the function must move: the header of each record on
            # the chain and of the position it stops at (one 32-byte
            # sector each, the least the memory reads), 16 bytes of
            # offset and length a record and the 24-byte status; reading
            # the whole window once is a separate, looser figure
            scan = dict(
                window=kind, window_bytes=L, records=n, tile=df.SCAN_TILE,
                ms=self._time(lambda: df.scan_window(image, 0, last), 10),
                plain_ms=self._time(
                    lambda: df.scan_window_plain(image, 0, last), 2),
                bound_ms=(32 * (n + 1) + 16 * n + 24)
                / HBM_BYTES_PER_S * 1e3,
                window_read_ms=L / HBM_BYTES_PER_S * 1e3,
                library_ms=None)
            scan.update(self._scan_passes(image, last, df.SCAN_TILE))
            scan["share_of_bound"] = scan["bound_ms"] / scan["ms"]
            scan["tiles_ms"] = {
                tile: dict(ms=self._time(lambda: df.scan_window(
                    image, 0, last, tile=tile), 5),
                    **self._scan_passes(image, last, tile))
                for tile in (8192, 16384, 32768, 65536)}
            # the packs of the main path at this window: the segment-id
            # field of every record, and the widest segment
            packs = []
            props = seg_field.binary_properties
            o, ln, extent, rows = max(shapes.values(),
                                      key=lambda v: v[2] * v[3])
            for what, po, pl, pe, start in [
                    ("segment_id", offs_d, lens_d, props.actual_size,
                     props.offset),
                    ("widest_segment", o, ln, extent, 0)]:
                packs.append(self._time_pack(kind, what, image, po, pl, pe,
                                             start))
            self.rdw_timings[kind] = dict(scan=scan, packs=packs)
            log(f"[rdw-time] {self.card}: {kind} rdw_scan "
                f"{json.dumps(scan)}")
            for pack in packs:
                log(f"[rdw-time] {self.card}: {kind} pack_records "
                    f"{json.dumps(pack)}")
        for kind, (size, secs) in self.rdw_e2e.items():
            log(f"[rdw-time] {self.card}: {kind} read_cobol end to end: "
                f"{size} bytes in {secs:.3f} s = {size / secs / 1e6:.1f} "
                f"MB/s; launches {json.dumps(self.launches['rdw_' + kind])}")

    def _scan_passes(self, image, last, tile):
        """The scan's passes one by one, each between CUDA events (median
        of 10): exits, chain, count, the read-back of the count and
        status (host included), records; and the tiles the chain
        entered."""
        torch = self.torch
        from cobrix_tpu_torch.ops import device_framing as df

        if self.rehearsal:
            return {}
        names = ("exits_ms", "chain_ms", "count_ms", "head_ms", "records_ms")
        runs = []
        for _ in range(13):
            scan = df.ScanPasses(image, 0, last, False, 0, tile)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            scan.exits()
            ev[1].record()
            scan.chain()
            ev[2].record()
            scan.count()
            ev[3].record()
            n, _, hops = scan.head()
            ev[4].record()
            scan.records(n)
            ev[5].record()
            ev[5].synchronize()
            runs.append([ev[k].elapsed_time(ev[k + 1]) for k in range(5)])
        passes = {name: statistics.median(r[k] for r in runs[3:])
                  for k, name in enumerate(names)}
        return dict(passes=passes, hops=hops,
                    tiles=-(-image.numel() // tile))

    def _time_pack(self, kind, what, image, o, ln, extent, start):
        """One pack shape: kernel against plain, timed beside its plain
        version, one PyTorch indexing call and the byte bound."""
        torch = self.torch
        from cobrix_tpu_torch.ops import device_framing as df

        a = df.pack_records(image, o, ln, extent, start)
        self.same(a, df.pack_records_plain(image, o, ln, extent, start),
                  f"{kind} {what} pack", "pack_records")
        del a
        rows = int(o.numel())
        L = image.numel()
        cols = torch.arange(extent, device=self.device)
        gather = torch.clamp(o[:, None] + start + cols[None, :], 0, L - 1)
        # each record's bytes from `start` up to the extent, its offset and
        # length (16 bytes), and the packed matrix
        moved = (int(torch.clamp(ln - start, min=0, max=extent).sum())
                 + 16 * rows + rows * extent)
        pack = dict(
            window=kind, pack=what, rows=rows, extent=extent,
            start_offset=start,
            ms=self._time(lambda: df.pack_records(image, o, ln, extent,
                                                  start), 20),
            device_ms=self._time(lambda: df.pack_records(
                image, o, ln, extent, start), 20, busy=True),
            plain_ms=self._time(
                lambda: df.pack_records_plain(image, o, ln, extent, start),
                5),
            library_ms=self._time(lambda: image[gather], 20),
            bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        pack["share_of_bound"] = pack["bound_ms"] / pack["device_ms"]
        return pack

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

    # -- the pipelined read ------------------------------------------------

    def _digest(self, data):
        """(hash, records): sha256 over every host plane, column by
        column in record order (per active segment), the record ids and
        Seg_Id columns, and the decoded values of sampled records (the
        first and last 100 of a fixed-length read, the first 50 of each
        segment of an RDW read). Chunk and shard boundaries do not change
        it."""
        np = self.np
        hashers = {}

        def feed(key, arr):
            h = hashers.get(key)
            if h is None:
                h = hashers[key] = hashlib.sha256()
            if isinstance(arr, np.ndarray) and arr.dtype != object:
                h.update(np.ascontiguousarray(arr).tobytes())
            else:
                h.update(repr(list(arr)).encode())

        def planes(active, batch):
            for col in range(len(batch.decoder.plan.columns)):
                for key, arr in sorted(batch.column_arrays(col).items()):
                    feed((active, col, key), arr)

        def values(batch, i):
            """Record i's decoded values (a row's leaves, without
            building the batch's whole row columns)."""
            return [batch.value(col, i)
                    for col in range(len(batch.decoder.plan.columns))]

        rows = []
        n = sum(b.n_records for b in data.batches)
        sample = set(range(min(100, n))) | set(range(max(0, n - 100), n))
        first = 0
        for b in data.batches:
            planes(None, b)
            rows += [values(b, i - first) for i in sorted(sample)
                     if first <= i < first + b.n_records]
            first += b.n_records
        for r in data.results:
            for seg in r.segments:
                planes(seg.active, seg.batch)
                feed((seg.active, "record_ids"), seg.record_ids)
                if seg.seg_level_ids is not None:
                    c = seg.seg_level_ids.coded
                    feed((seg.active, "root_rid"), c["root_rid"])
                    for lvl, (cnt, valid) in enumerate(zip(c["counters"],
                                                           c["valids"])):
                        if cnt is not None:
                            feed((seg.active, "counter", lvl), cnt)
                        feed((seg.active, "valid", lvl), valid)
        taken = {}  # the first 50 records of each active segment
        for r in data.results:
            for seg in r.segments:
                got = taken.setdefault(seg.active, [])
                got += [values(seg.batch, i) for i in range(
                    min(50 - len(got), seg.batch.n_records))]
        rows += sorted(taken.items(), key=repr)
        feed(("rows",), [repr(rows)])
        top = hashlib.sha256()
        for key in sorted(hashers, key=repr):
            top.update(repr(key).encode() + hashers[key].digest())
        return top.hexdigest(), len(data)

    def _pipelined_read(self, tag, path, cb, workers, keep=False, **opts):
        """One read through read_cobol with `workers`, its kernels'
        launches counted from 0; (seconds, digest, records, metrics,
        launches). `keep`: the CobolData stays in `self.kept`."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import fused_decode

        counters = {"fused_decode": fused_decode, "rdw_scan": df.scan_window,
                    "pack_records": df.pack_records}
        kw = {"device": "cpu"} if self.rehearsal else {}
        for fn in counters.values():
            fn.launches = 0
        self.sync()
        t0 = time.perf_counter()
        data = read_cobol(path, copybook_contents=cb,
                          pipeline_workers=str(workers),
                          chunk_size_mb=self.pipe_chunk_mb, **opts, **kw)
        self.sync()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches or k == "fused_decode"}
        digest, records = self._digest(data)
        self.last_diagnostics = data.diagnostics
        if keep:
            self.kept = data
        return secs, digest, records, data.metrics.as_dict(), launches

    def phase_pipeline(self):
        """The pipelined read on the default device (see the module
        docstring, phase 9)."""
        from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                         EXP2_COPYBOOK,
                                                         EXP3_COPYBOOK)

        self.pipe_chunk_mb = "0.25" if self.rehearsal else "64"
        self.pipeline = {}
        files = [("exp1", self.exp1_path, EXP1_COPYBOOK, {}),
                 ("exp3", self.rdw_files["exp3"], EXP3_COPYBOOK,
                  RDW_OPTIONS),
                 ("exp2", self.rdw_files["exp2"], EXP2_COPYBOOK,
                  RDW_OPTIONS)]
        for kind, path, cb, opts in files:
            size = os.path.getsize(path)
            runs = []
            for workers in (0, 2):
                secs, digest, records, metrics, launches = \
                    self._pipelined_read(kind, path, cb, workers, **opts)
                runs.append(dict(workers=workers, secs=secs,
                                 mb_per_s=size / secs / 1e6,
                                 launches=launches, shards=metrics["shards"],
                                 pipeline=metrics["pipeline"],
                                 stage_busy=metrics["stage_busy"]))
                log(f"[pipeline] {self.card}: {kind} workers {workers}: "
                    f"{records} records, {size} bytes in {secs:.3f} s = "
                    f"{size / secs / 1e6:.1f} MB/s; shards "
                    f"{metrics['shards']}; launches {json.dumps(launches)}")
                if metrics["pipeline"] is not None:
                    log(f"[pipeline]   report {json.dumps(metrics['pipeline'])}"
                        f"; stage busy {json.dumps(metrics['stage_busy'])}")
                runs[-1]["digest"] = digest
                check(digest == runs[0]["digest"],
                      f"{kind} workers {workers}: planes or rows differ "
                      f"from the sequential read")
            seq, pipe2 = runs[0], runs[1]
            self.launches[f"pipeline_{kind}"] = pipe2["launches"]
            self.raw_reads[kind] = dict(
                digest=seq["digest"], launches=seq["launches"],
                pipe_launches=pipe2["launches"],
                mb_per_s=[seq["mb_per_s"], pipe2["mb_per_s"]])
            if not self.rehearsal:
                if kind == "exp1":
                    check(pipe2["launches"] == seq["launches"],
                          f"exp1: the same chunk plan launched "
                          f"{pipe2['launches']} pipelined and "
                          f"{seq['launches']} sequential")
                for k, v in pipe2["launches"].items():
                    check(v > 0, f"{k} never launched on the pipelined "
                          f"{kind} read")
                if kind != "exp1":
                    check(set(pipe2["launches"]) == set(READ_KERNELS),
                          f"{kind}: a kernel of the RDW path never "
                          f"launched: {pipe2['launches']}")
            log(f"[pipeline] {self.card}: {kind} MB/s in turns (workers 0, "
                f"2): " + " / ".join(
                    f"{r['mb_per_s']:.1f}" for r in runs)
                + "; outputs equal by hash")
            self.pipeline[kind] = [{k: v for k, v in r.items()
                                    if k != "digest"} for r in runs]
            if kind == "exp2":
                self.exp2_digest = seq["digest"]

        # many shards: the staging pool's buffers go round many times
        split = max(1, self.n_rdw["exp2"] // 64)
        secs, digest, records, metrics, launches = self._pipelined_read(
            "exp2", self.rdw_files["exp2"], EXP2_COPYBOOK, -1,
            input_split_records=str(split), **RDW_OPTIONS)
        staging = metrics["pipeline"]["staging"]
        log(f"[pipeline] {self.card}: exp2 in {metrics['shards']} shards "
            f"(input_split_records {split}): {secs:.3f} s; staging "
            f"{json.dumps(staging)}; launches {json.dumps(launches)}")
        check(metrics["shards"] > 50, f"exp2 split into only "
              f"{metrics['shards']} shards")
        check(staging["acquires"] > staging["buffers"],
              "the staging buffers were not reused")
        check(digest == self.exp2_digest, "exp2 in many shards: planes or "
              "rows differ from the sequential read (a staging buffer "
              "reused too early?)")
        log("[pipeline] exp2 in many shards == sequential read by hash")
        self._pipeline_trace()

    def _pipeline_trace(self):
        """One pipelined exp1 read under the port's profile_trace: device
        busy time and idle share, copies by kind, streams, and the
        copies' overlap with kernels (from the Chrome trace's device
        events)."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.profiling import TRACE_FILE, profile_trace
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        tdir = os.path.join(self.tmp, "trace")
        kw = {"device": "cpu"} if self.rehearsal else {}
        self.sync()
        with profile_trace(tdir):
            t0 = time.perf_counter()
            data = read_cobol(self.exp1_path, copybook_contents=EXP1_COPYBOOK,
                              pipeline_workers="-1",
                              chunk_size_mb=self.pipe_chunk_mb, **kw)
            self.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        batches = len(data.batches)
        report = data.metrics.pipeline
        del data
        with open(os.path.join(tdir, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        by_name, streams = {}, {"kernel": set(), "gpu_memcpy": set()}
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0) + 1
            if e["cat"] in streams:
                streams[e["cat"]].add(e.get("args", {}).get("stream"))

        def union(spans):
            out = []
            for a, b in sorted(spans):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            return out

        def measure(u):
            return sum(b - a for a, b in u)

        def intersect(u, v):
            i = j = 0
            total = 0.0
            while i < len(u) and j < len(v):
                lo, hi = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
                total += max(0.0, hi - lo)
                if u[i][1] < v[j][1]:
                    i += 1
                else:
                    j += 1
            return total

        def spans(cat, word=""):
            return [(e["ts"], e["ts"] + e["dur"]) for e in dev
                    if e["cat"] == cat and word in e["name"]]

        trace = dict(wall_ms=wall_ms, batches=batches,
                     copies={k: v for k, v in by_name.items()
                             if k.startswith("Memcpy")},
                     kernel_streams=len(streams["kernel"]),
                     copy_streams=len(streams["gpu_memcpy"]),
                     executor=report)
        if dev:
            busy = measure(union([(e["ts"], e["ts"] + e["dur"])
                                  for e in dev])) / 1e3
            kernels = union(spans("kernel"))
            h2d, d2h = union(spans("gpu_memcpy", "HtoD")), \
                union(spans("gpu_memcpy", "DtoH"))
            trace.update(
                device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
                kernel_ms=measure(kernels) / 1e3,
                h2d_ms=measure(h2d) / 1e3, d2h_ms=measure(d2h) / 1e3,
                h2d_overlap_kernels_ms=intersect(h2d, kernels) / 1e3,
                d2h_overlap_kernels_ms=intersect(d2h, kernels) / 1e3,
                h2d_overlap_d2h_ms=intersect(h2d, d2h) / 1e3)
            pinned_d2h = sum(v for k, v in by_name.items()
                             if k.startswith("Memcpy DtoH")
                             and "Pinned" in k)
            pageable_d2h = sum(v for k, v in by_name.items()
                               if k.startswith("Memcpy DtoH")
                               and "Pageable" in k)
            pinned_h2d = sum(v for k, v in by_name.items()
                             if k.startswith("Memcpy HtoD")
                             and "Pinned" in k)
            # a batch: the decode's one copy back, and its table's
            # assembly (the string data's size, then every Arrow buffer
            # in one copy); up: the chunk, and the assembly's planes and
            # tables
            check(pinned_d2h == 3 * batches and pageable_d2h == 0,
                  f"traced read: {pinned_d2h} pinned and {pageable_d2h} "
                  f"pageable copies back for {batches} batches (3 each)")
            check(pinned_h2d == 3 * report["chunks"],
                  f"traced read: {pinned_h2d} pinned copies to the card "
                  f"for {report['chunks']} chunks (3 each); copies "
                  f"{trace['copies']}")
            check(len(streams["kernel"]) >= 2,
                  f"traced read: kernels ran on {len(streams['kernel'])} "
                  f"stream(s)")
        else:
            log("[pipeline] the trace holds no device time: busy, idle "
                "share and copies not measured")
        self.pipeline["trace"] = trace
        log(f"[pipeline] {self.card}: traced exp1 read: {json.dumps(trace)}")

    # -- the device-resident query path -------------------------------------

    def _valid_counts(self, batches, limit):
        """decode_stats' dict from the host planes of a read's batches,
        over their first `limit` records: each group's valid values
        (JAX keys, a later group of one codec and width overwriting an
        earlier one's entry) and their total."""
        from cobrix_tpu_torch.reader.columnar import (_FLOAT_CODECS,
                                                      _NUMERIC_CODECS)

        groups = batches[0].decoder.kernel_groups
        per_group, total = {}, 0
        for g in groups:
            if g.codec not in _NUMERIC_CODECS + _FLOAT_CODECS:
                continue
            count, first = 0, 0
            for b in batches:
                rows = max(0, min(b.n_records, limit - first))
                first += b.n_records
                for c in g.columns:
                    count += int(b.column_arrays(c.index)["valid"][:rows]
                                 .sum())
            per_group[f"{g.codec.value}_w{g.width}"] = count
            total += count
        return {"records": limit, "valid_values": total, **per_group}

    def _plane_stats(self, batches, names):
        """Per field: count, sum, min and max of the valid values of the
        host planes of a read's batches (integral fields: exact)."""
        np = self.np
        out = {}
        for name in names:
            count, total, lo, hi = 0, 0, None, None
            for b in batches:
                for c in b.decoder.plan.columns:
                    if c.name != name:
                        continue
                    arr = b.column_arrays(c.index)
                    v = arr["values"][arr["valid"]].astype(np.int64)
                    if not v.size:
                        continue
                    count += int(v.size)
                    total += int(v.sum())
                    lo = int(v.min()) if lo is None else min(lo, int(v.min()))
                    hi = int(v.max()) if hi is None else max(hi, int(v.max()))
            out[name] = dict(count=count, sum=total, min=lo, max=hi)
        return out

    def _same_stats(self, a, b, what, rtol):
        """Counts, min and max equal, sums to `rtol`."""
        check(set(a) == set(b), f"{what}: fields {set(a)} vs {set(b)}")
        for name in a:
            x, y = a[name], b[name]
            for key in ("count", "min", "max"):
                check(x[key] == y[key],
                      f"{what}: {name} {key} {x[key]} vs {y[key]}")
            check((x["sum"] is None) == (y["sum"] is None)
                  and (x["sum"] is None or abs(x["sum"] - y["sum"])
                       <= rtol * abs(y["sum"])),
                  f"{what}: {name} sum {x['sum']} vs {y['sum']}")

    def _check_aggregate(self, agg, x, n, what):
        """The aggregate kernel against aggregate_plain on the card, on
        the planes the path decodes: counts, min and max exact, sums to
        rtol 1e-12."""
        np, torch = self.np, self.torch
        from cobrix_tpu_torch.ops import aggregate as ag

        dp = agg.decoder.decode_planes(x)
        a = ag.aggregate(dp.planes, agg.spec, n,
                         ag.new_stats(agg.spec.n_fields, x.device))
        b = ag.aggregate_plain(dp.planes, agg.spec, n,
                               ag.new_stats(agg.spec.n_fields, x.device))
        ha, hb = (ag.read_stats(s.buffer.cpu().numpy(), agg.spec.n_fields)
                  for s in (a, b))
        for k, key in ((1, "counts"), (2, "mins"), (3, "maxs")):
            self.same(ha[k], hb[k], f"{what} aggregate {key}", "aggregate")
        err = float(np.max(np.abs(ha[0] - hb[0]))) if len(ha[0]) else 0.0
        self.max_err["aggregate"] = max(self.max_err["aggregate"], err)
        nz = hb[0] != 0
        if nz.any():
            self.agg_rel_err = max(self.agg_rel_err, float(np.max(
                np.abs(ha[0][nz] - hb[0][nz]) / np.abs(hb[0][nz]))))
        check(np.allclose(ha[0], hb[0], rtol=1e-12, atol=0),
              f"{what}: aggregate sums differ from the plain version by "
              f"{err}")

    def check_aggregate_modes(self):
        """The aggregate kernel against aggregate_plain on the card for
        every kind and scale mode: the exp1 planes (the first records of
        the phase 3 file) and the ``WIDE_COPYBOOK`` rows, each in a block
        of 4,096 rows with `n` on the host, and at N = 37 rows (no
        multiple of 16) with `n` a 0-d int32 on the card at N, below it,
        0 and past N."""
        np, torch = self.np, self.torch
        from cobrix_tpu_torch import parse_copybook
        from cobrix_tpu_torch.ops import aggregate as ag
        from cobrix_tpu_torch.parallel import DeviceAggregator
        from cobrix_tpu_torch.testing.aggregate_cases import (WIDE_COPYBOOK,
                                                              wide_rows)
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        n_exp1 = 300 if self.rehearsal else 3000
        exp1 = np.fromfile(self.exp1_path, dtype=np.uint8,
                           count=n_exp1 * 1493).reshape(-1, 1493)
        held = set()
        for name, cb, rows in (("exp1", EXP1_COPYBOOK, exp1),
                               ("wide", WIDE_COPYBOOK, wide_rows())):
            agg = DeviceAggregator(parse_copybook(cb), device=self.device)
            held |= {(int(d[ag._D_KIND]), int(d[ag._D_MODE]))
                     for d in agg.spec.desc}
            x, n = agg.put(rows, block=4096)
            self._check_aggregate(agg, x, n, f"{name} block of 4,096")
            if name == "exp1":  # timed with the query's shapes
                self.agg_exp1 = (agg, x, n)
            x37, _ = agg.put(np.resize(rows, (37, rows.shape[1])))
            check(x37.shape[0] == 37, "the N = 37 batch is padded")
            for k in (37, 20, 0, 46):
                n37 = torch.tensor(k, dtype=torch.int32, device=self.device)
                self._check_aggregate(agg, x37, n37,
                                      f"{name} N = 37, n = {k} on the card")
        check({k for k, _ in held} == set(AGG_KINDS)
              and {m for _, m in held} == set(AGG_MODES),
              f"the aggregate checks hold (kind, mode) {sorted(held)} only")
        self.agg_modes_held = sorted(f"{AGG_KINDS[k]}/{AGG_MODES[m]}"
                                     for k, m in held)
        log(f"[query] aggregate kernel == plain (counts, min, max exact; "
            f"sums to rtol 1e-12) for kind/mode {self.agg_modes_held}: exp1 "
            f"({n_exp1} records) and wide rows in blocks of 4,096, and at "
            f"N = 37 with n = 37, 20, 0, 46 on the card")

    def _agg_bytes(self, agg, n):
        """Bytes the aggregate must move for `n` live rows: each fused
        column's value (and lo and sign; dots in the dots mode) and its
        valid flag (the spec's row bytes), and the per-field outputs."""
        return n * agg.spec.row_bytes + 28 * agg.spec.n_fields

    def _time_aggregate(self, agg, x, n, what):
        """The aggregate kernel at one main-path shape. `ms` (events
        around a call on an idle stream) and `device_ms` (stream held busy
        first) time fresh outputs and the wrapper, as ``submit`` runs them;
        `kernel_device_ms` the wrapper alone on outputs made before;
        beside them the fresh outputs alone, an empty launch
        (``torch.cuda._sleep(0)``), one ``torch.sum`` over the i32 plane
        (a bandwidth reference: not the same function), the plain version
        and the byte bound."""
        torch = self.torch
        from cobrix_tpu_torch.ops import aggregate as ag

        dp = agg.decoder.decode_planes(x)
        F = agg.spec.n_fields
        stats = ag.new_stats(F, x.device)
        i32 = dp.planes["i32"]

        def submit():
            ag.aggregate(dp.planes, agg.spec, n, agg.spec.new_stats(x.device))

        def kernel():
            ag.aggregate(dp.planes, agg.spec, n, stats)

        def plain():
            ag.aggregate_plain(dp.planes, agg.spec, n,
                               ag.new_stats(F, x.device))

        live = int(n)
        row = dict(shape=what, rows=int(x.shape[0]), live=live,
                   columns=agg.spec.n_cols, fields=F,
                   ms=self._time(submit, 20),
                   device_ms=self._time(submit, 20, busy=True),
                   kernel_device_ms=self._time(kernel, 20, busy=True),
                   new_stats_device_ms=self._time(
                       lambda: agg.spec.new_stats(x.device), 20, busy=True),
                   empty_launch_device_ms=(
                       None if self.rehearsal else
                       self._time(lambda: torch.cuda._sleep(0), 20,
                                  busy=True)),
                   torch_sum_i32_plane=dict(
                       shape=list(i32.shape), bytes=i32.numel() * 4,
                       device_ms=self._time(lambda: i32.sum(), 20,
                                            busy=True)),
                   plain_ms=self._time(plain, 3),
                   bound_ms=self._agg_bytes(agg, live) / HBM_BYTES_PER_S
                   * 1e3, library_ms=None)
        if not self.rehearsal:
            row["grid"] = int(ag.class_grids(x.device)[0])
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        row["kernel_share_of_bound"] = (row["bound_ms"]
                                        / row["kernel_device_ms"])
        return row

    def phase_query(self):
        """Phase 10: the device-resident query path (module docstring)."""
        np, torch = self.np, self.torch
        from cobrix_tpu_torch.api import parse_options
        from cobrix_tpu_torch.ops import aggregate as ag
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import fused_decode
        from cobrix_tpu_torch.parallel import (DeviceAggregator,
                                               ShardedColumnarDecoder,
                                               merge_aggregates)
        from cobrix_tpu_torch.reader.var_len_reader import VarLenReader
        from cobrix_tpu_torch import parse_copybook
        from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                         EXP3_COPYBOOK)

        counters = {"fused_decode": fused_decode, "rdw_scan": df.scan_window,
                    "pack_records": df.pack_records, "aggregate": ag.aggregate}

        def reset():
            self.sync()
            for fn in counters.values():
                fn.launches = 0

        def launches():
            return {k: fn.launches for k, fn in counters.items()
                    if fn.launches}

        self.query = {}
        self.check_aggregate_modes()
        raw = self.rdw_walk["exp3"][0]
        size = len(raw)
        mb = size / 1e6
        reader = VarLenReader(EXP3_COPYBOOK, parse_options(RDW_OPTIONS),
                              device=self.device)
        agg = DeviceAggregator(reader.copybook, columns=list(QUERY_FIELDS),
                               active_segment="STATIC_DETAILS",
                               device=self.device)
        rs = agg.record_extent
        block = (32 if self.rehearsal else
                 max(512, (32 * 1024 * 1024 // rs + 255) // 256 * 256))
        buf = np.frombuffer(raw, dtype=np.uint8)

        def frame_and_pack():
            """The host side of the block query: a sequential walk of the
            headers, then the wide 'C' records copied into blocks of
            [block, rs] (zero past a record's end)."""
            offsets, lengths = host_walk(raw)
            wide = [(o, min(ln, rs)) for o, ln in zip(offsets, lengths)
                    if ln >= 1000]
            mats = []
            for i in range(0, len(wide), block):
                part = wide[i:i + block]
                mat = np.zeros((len(part), rs), dtype=np.uint8)
                for row, (o, ln) in zip(mat, part):
                    row[:ln] = buf[o:o + ln]
                mats.append(mat)
            return mats

        # (a) the block query: host framing, put / submit / fetch
        t0 = time.perf_counter()
        mats = frame_and_pack()
        pack_s = time.perf_counter() - t0
        x, n = agg.put(mats[0], block=block)
        self._check_aggregate(agg, x, n, "exp3 block")
        agg.aggregate_device(x, n)  # warm-up
        c_bytes = sum(m.nbytes for m in mats)
        h2d_s = comp_s = 0.0
        for m in mats:
            t0 = time.perf_counter()
            x, n = agg.put(m, block=block)
            self.sync()
            h2d_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            agg.aggregate_device(x, n)
            comp_s += time.perf_counter() - t0
        times = []
        for _ in range(2):
            reset()
            t0 = time.perf_counter()
            pend = []
            for m in frame_and_pack():
                pend.append(agg.submit(*agg.put(m, block=block)))
            parts = [agg.fetch(p) for p in pend]
            times.append(time.perf_counter() - t0)
            self.launches["query_blocks"] = launches()
        blocks_res = merge_aggregates(parts)
        d2h_bytes = sum(p.buffer.numel() for p in pend)
        want = self.exp3_planes
        for name in QUERY_FIELDS:
            r, w = blocks_res[name], want[name]
            check(r["count"] == w["count"] and r["min"] == w["min"]
                  and r["max"] == w["max"]
                  and abs(r["sum"] - w["sum"]) <= 1e-12 * abs(w["sum"]),
                  f"block query {name} {r} != the sequential read's planes "
                  f"{w}")
        # NUM1 alone, byte-projected
        agg1 = DeviceAggregator(reader.copybook, columns=["NUM1"],
                                active_segment="STATIC_DETAILS",
                                device=self.device)
        check(agg1.gather_index is not None, "NUM1 alone is not projected")
        x1, n1 = agg1.put(mats[0], block=block)
        self._check_aggregate(agg1, x1, n1, "exp3 NUM1 block")
        agg1.aggregate_device(x1, n1)
        times1 = []
        for _ in range(2):
            t0 = time.perf_counter()
            pend1 = [agg1.submit(*agg1.put(m, block=block)) for m in mats]
            parts1 = [agg1.fetch(p) for p in pend1]
            times1.append(time.perf_counter() - t0)
        num1 = merge_aggregates(parts1)["NUM1"]
        self._same_stats({"NUM1": num1}, {"NUM1": blocks_res["NUM1"]},
                         "NUM1 alone vs NUM1 and NUM2", 1e-12)
        blocks = dict(
            file_bytes=size, wide_records=sum(m.shape[0] for m in mats),
            blocks=len(mats), block_records=block, record_extent=rs,
            host_frame_pack_s=pack_s, h2d_MBps=c_bytes / 1e6 / h2d_s,
            device_compute_MBps=c_bytes / 1e6 / comp_s,
            end_to_end_MBps=mb / min(times), end_to_end_s=times,
            d2h_bytes=d2h_bytes,
            num1_projected=dict(
                projection_ratio=rs / len(agg1.gather_index),
                end_to_end_MBps=mb / min(times1), end_to_end_s=times1),
            launches=self.launches["query_blocks"])
        self.query["blocks"] = blocks
        log(f"[query] {self.card}: (a) exp3 block query: "
            f"{json.dumps(blocks)}")
        log(f"[query] block query == the sequential read's planes "
            f"(counts, min, max exact; sums to rtol 1e-12)")

        # (b) the on-HBM pipeline: one H2D of the image, then frame, select,
        # pack, decode and aggregate on the card, one D2H
        cap = -(-int(size / 16072 * 1.25 + 8) // 256) * 256
        fn = df.build_wide_pipeline(rs, cap=cap, columns=agg.gather_index)
        host = torch.from_numpy(buf.copy())
        self.sync()
        t0 = time.perf_counter()
        image = (host if self.rehearsal
                 else host.pin_memory().to(self.device, non_blocking=True))
        self.sync()
        h2d_s = time.perf_counter() - t0
        del host
        agg.fetch(agg.submit(*fn(image)))  # warm-up
        # the scan's capped mode against the full scan on the card
        offs_f, lens_f, _ = df.scan_window(image, 0, True)
        header = df._header_lengths(image, False, 0)[offs_f - 4]
        wide = torch.nonzero(header >= 1000).flatten()
        o, ln, live = df.scan_capped(image, 1000, cap)
        k = int(live)
        check(k == min(cap, int(wide.numel())), "capped scan count")
        self.same(o[:k], offs_f[wide[:k]], "capped scan offsets", "rdw_scan")
        self.same(ln[:k], lens_f[wide[:k]], "capped scan lengths",
                  "rdw_scan")
        check(not bool(o[k:].any()) and not bool(ln[k:].any()),
              "capped scan: rows past the count are not zero")
        del offs_f, lens_f, header, wide
        # ... and against its plain version on the same whole image:
        # offsets, lengths and the live count, exact (one plain call, its
        # doubling over every position holds some 40 GB for a while)
        self.sync()
        t0 = time.perf_counter()
        po, pln, plive = df.scan_capped_plain(image, 1000, cap)
        self.sync()
        scan_plain_s = time.perf_counter() - t0
        self.same(o, po, "capped scan offsets vs plain", "rdw_scan")
        self.same(ln, pln, "capped scan lengths vs plain", "rdw_scan")
        self.same(live, plive, "capped scan count vs plain", "rdw_scan")
        del o, ln, po, pln, plive
        if not self.rehearsal:
            torch.cuda.empty_cache()
        self._check_aggregate(agg, *fn(image), "exp3 on-HBM pipeline")
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            reset()
            t0 = time.perf_counter()
            res = agg.fetch(agg.submit(*fn(image)))
            times.append(time.perf_counter() - t0)
            self.launches["query_pipeline"] = launches()
        peak = (None if self.rehearsal else
                torch.cuda.max_memory_allocated())
        self._same_stats(res, blocks_res, "on-HBM pipeline vs block query",
                         1e-9)
        # no host round trip between the H2D and fetch
        if not self.rehearsal:
            self.sync()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tree = agg.submit(*fn(image))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self._same_stats(agg.fetch(tree), res, "sync-debug run", 1e-9)
        # one run traced: no copy to the card, one copy back (the fetch)
        from cobrix_tpu_torch.profiling import TRACE_FILE, profile_trace

        tdir = os.path.join(self.tmp, "query_trace")
        self.sync()
        with profile_trace(tdir):
            agg.fetch(agg.submit(*fn(image)))
            self.sync()
        with open(os.path.join(tdir, TRACE_FILE)) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") in
                      ("kernel", "gpu_memcpy", "gpu_memset")]
        dtoh = sum(1 for e in events if e["name"].startswith("Memcpy DtoH"))
        htod = sum(1 for e in events if e["name"].startswith("Memcpy HtoD"))
        # the CPU rehearsal's trace holds no device events; on the card a
        # trace without them cannot show the one copy back, and fails
        check(bool(events) or self.rehearsal, "the traced run of the "
              "on-HBM pipeline holds no kernel or copy events")
        if events:
            check(dtoh == 1 and htod == 0, f"a traced run of the on-HBM "
                  f"pipeline made {htod} HtoD and {dtoh} DtoH copies")
        names = events
        pipeline = dict(
            file_bytes=size, cap=cap, h2d_MBps=mb / h2d_s,
            device_pipeline_MBps=mb / min(times), device_pipeline_s=times,
            end_to_end_MBps=mb / (h2d_s + min(times)),
            wide_records=res["NUM1"]["count"] // 2000,
            peak_device_bytes=peak,
            traced_run_copies=dict(htod=htod, dtoh=dtoh) if names else None,
            launches=self.launches["query_pipeline"],
            sync_debug="error" if not self.rehearsal else None)
        # the NUM1 projection's gather after the pack, timed alone
        fn1 = df.build_wide_pipeline(agg1.record_extent, cap=cap,
                                     columns=agg1.gather_index)
        r1 = agg1.fetch(agg1.submit(*fn1(image)))
        self._same_stats(r1, {"NUM1": res["NUM1"]}, "projected pipeline",
                         1e-9)
        o, ln, live = df.scan_capped(image, 1000, cap)
        pack_extent = int(agg1.gather_index.max()) + 1
        # the pack against its plain version at the pipeline's shapes: the
        # whole extent and the projection's, exact
        for width in (rs, pack_extent):
            self.same_on_card(df.pack_records(image, o, ln, width),
                              df.pack_records_plain(image, o, ln, width),
                              f"pipeline pack at extent {width}",
                              "pack_records")
        if not self.rehearsal:
            torch.cuda.empty_cache()
        packed = df.pack_records(image, o, ln, pack_extent)
        cols = torch.from_numpy(agg1.gather_index).to(self.device)
        pipeline["num1_projection"] = dict(
            width=int(cols.numel()), pack_extent=pack_extent,
            pack_ms=self._time(lambda: df.pack_records(image, o, ln,
                                                       pack_extent), 5),
            gather_ms=self._time(lambda: packed.index_select(1, cols), 5),
            pipeline_ms=self._time(lambda: agg1.submit(*fn1(image)), 3))
        del packed
        # the capped scan at the whole image and at a 64 MiB prefix
        n_chain = len(self.rdw_walk["exp3"][1][0])
        cut = image[:min(image.numel(), 64 << 20)]
        pipeline["capped_scan"] = dict(
            image_bytes=int(image.numel()), records_on_chain=n_chain,
            kept=k, ms=self._time(lambda: df.scan_capped(image, 1000, cap),
                                  5),
            bound_ms=(32 * (n_chain + 1) + 16 * k + 4)
            / HBM_BYTES_PER_S * 1e3,
            prefix_bytes=int(cut.numel()),
            prefix_ms=self._time(lambda: df.scan_capped(cut, 1000, cap), 5),
            prefix_plain_ms=self._time(
                lambda: df.scan_capped_plain(cut, 1000, cap), 1),
            plain_ms_one_call=scan_plain_s * 1e3,
            library_ms=None)
        pipeline["pack"] = dict(
            rows=cap, extent=rs,
            ms=self._time(lambda: df.pack_records(image, o, ln, rs), 5))
        self.query["pipeline"] = pipeline
        log(f"[query] {self.card}: (b) exp3 on-HBM pipeline: "
            f"{json.dumps(pipeline)}")
        log("[query] on-HBM pipeline == block query (counts, min, max "
            "exact; sums to rtol 1e-9); capped scan and pipeline pack == "
            "their plain versions (exact)" + ("" if self.rehearsal else
                                           "; submit ran under sync debug "
                                           "'error'; a traced run: no HtoD, "
                                           "one DtoH copy"))
        # the aggregate kernel at the two shapes of the path
        x, n = agg.put(mats[0], block=block)
        px, plive = fn(image)
        self.query["aggregate"] = [
            self._time_aggregate(agg, x, n, "exp3 block"),
            self._time_aggregate(agg, px, plive, "exp3 on-HBM pipeline"),
            self._time_aggregate(*self.agg_exp1,
                                 "exp1 every numeric field")]
        for row in self.query["aggregate"]:
            log(f"[query] {self.card}: aggregate {json.dumps(row)}")
        del image, px, x, mats

        # (c) exp1 decode_stats on a device-resident batch, whole
        dec = ShardedColumnarDecoder(parse_copybook(EXP1_COPYBOOK),
                                     device=self.device)
        data = np.fromfile(self.exp1_path, dtype=np.uint8,
                           count=self.n_exp1 * 1493).reshape(-1, 1493)
        xs, ns = dec.put(data)
        dec.decode_stats(xs, ns)  # warm-up
        times = []
        for _ in range(3):
            reset()
            t0 = time.perf_counter()
            stats = dec.decode_stats(xs, ns)
            times.append(time.perf_counter() - t0)
            self.launches["query_stats"] = launches()
        check(stats == self.exp1_valid, f"decode_stats {stats} != the "
              f"valid planes of the read {self.exp1_valid}")
        exp1 = dict(records=ns, bytes=int(data.nbytes), batches=1,
                    device_compute_MBps=data.nbytes / 1e6 / min(times),
                    seconds=times, valid_values=stats["valid_values"],
                    launches=self.launches["query_stats"])
        self.query["exp1_stats"] = exp1
        log(f"[query] {self.card}: (c) exp1 decode_stats, one batch of "
            f"{ns} records: {json.dumps(exp1)}")
        log("[query] decode_stats == the valid planes of the exp1 read")
        del xs, data
        if not self.rehearsal:
            for path, kernels in (("query_blocks", ("fused_decode",
                                                    "aggregate")),
                                  ("query_pipeline",
                                   READ_KERNELS + ("aggregate",)),
                                  ("query_stats", ("fused_decode",))):
                for k in kernels:
                    check(self.launches[path].get(k, 0) > 0,
                          f"{k} never launched on the {path} path")

    # -- phase 11: Arrow output and the record-shaping options ------------

    def _counted_read(self, tag, path, **opts):
        """read_cobol on the default device with each read kernel's
        launches counted from 0 and recorded under path `tag`, and the
        assembly kernels' counted from 0 too (`_count_arrow` adds them
        after the table is built); (data, seconds)."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import fused_decode

        for fn in asm.KERNELS.values():
            fn.launches = 0
        counters = {"fused_decode": fused_decode, "rdw_scan": df.scan_window,
                    "pack_records": df.pack_records}
        kw = {"device": "cpu"} if self.rehearsal else {}
        for fn in counters.values():
            fn.launches = 0
        self.sync()
        t0 = time.perf_counter()
        data = read_cobol(path, **opts, **kw)
        self.sync()
        secs = time.perf_counter() - t0
        self.launches[tag] = {k: fn.launches for k, fn in counters.items()
                              if fn.launches or k == "fused_decode"}
        if not self.rehearsal:
            check(self.launches[tag]["fused_decode"] > 0,
                  f"fused_decode never launched on the {tag} path")
        return data, secs

    def _count_arrow(self, tag):
        """The assembly kernels' launches since `_counted_read` began (its
        `to_arrow`, or its pipelined assemble stage) join path `tag`;
        the scalar kernel must have launched on the card."""
        from cobrix_tpu_torch.ops import arrow_assemble as asm

        got = {k: fn.launches for k, fn in asm.KERNELS.items()}
        self.launches[tag].update({k: v for k, v in got.items() if v})
        if not self.rehearsal:
            check(got["arrow_scalars"] > 0,
                  f"arrow_scalars never launched on the {tag} path")
        return got

    def _same_table(self, got, want, what):
        """Equal schemas (metadata included) and equal columns, structs
        flattened and floats compared by bit pattern (so NaNs compare)."""
        np = self.np
        import pyarrow as pa

        check(got.schema.equals(want.schema, check_metadata=True),
              f"{what}: schemas differ")
        check(got.num_rows == want.num_rows,
              f"{what}: {got.num_rows} rows vs {want.num_rows}")
        while any(pa.types.is_struct(f.type) for f in got.schema):
            got, want = got.flatten(), want.flatten()
        for name in want.column_names:
            a, b = got.column(name), want.column(name)
            if pa.types.is_floating(a.type):
                a, b = a.combine_chunks(), b.combine_chunks()
                same = a.is_null().equals(b.is_null()) and np.array_equal(
                    a.fill_null(0).to_numpy().view(np.uint8),
                    b.fill_null(0).to_numpy().view(np.uint8))
            else:
                same = a.equals(b)
            check(same, f"{what}: column {name} differs from the CPU read")

    def _cpu_table(self, raw, name, **opts):
        """The table of a device="cpu" read of the bytes `raw`."""
        from cobrix_tpu_torch import read_cobol

        path = os.path.join(self.tmp, name)
        with open(path, "wb") as f:
            f.write(raw)
        try:
            return read_cobol(path, device="cpu", **opts).to_arrow()
        finally:
            os.remove(path)

    def phase_arrow(self):
        """Phase 11: (a) to_arrow of the phase 3 and 4 files, (b) the
        pipelined read's assemble stage with batch_callback, (c) the
        record-shaping options on the card, each against a CPU read."""
        np = self.np
        import pyarrow as pa
        import pandas

        from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                         EXP2_COPYBOOK,
                                                         EXP3_COPYBOOK)

        log(f"[arrow] pyarrow {pa.__version__} pandas {pandas.__version__}")
        self.arrow = {}
        rs = 1493
        files = [("exp1", self.exp1_path, dict(
                     copybook_contents=EXP1_COPYBOOK)),
                 ("exp3", self.rdw_files["exp3"], dict(
                     copybook_contents=EXP3_COPYBOOK, **RDW_OPTIONS)),
                 ("exp2", self.rdw_files["exp2"], dict(
                     copybook_contents=EXP2_COPYBOOK, **RDW_OPTIONS))]
        for kind, path, opts in files:
            size = os.path.getsize(path)
            data, read_s = self._counted_read(f"arrow_{kind}", path, **opts)
            t0 = time.perf_counter()
            table = data.to_arrow()
            arrow_s = time.perf_counter() - t0
            self._count_arrow(f"arrow_{kind}")
            res = dict(bytes=size, read_s=read_s, to_arrow_s=arrow_s,
                       MBps=size / (read_s + arrow_s) / 1e6,
                       rows=table.num_rows, columns=table.num_columns,
                       nbytes=table.nbytes,
                       launches=self.launches[f"arrow_{kind}"])
            self.arrow[kind] = res
            log(f"[arrow] {self.card}: {kind} read {read_s:.3f} s + "
                f"to_arrow {arrow_s:.3f} s = {res['MBps']:.1f} MB/s over "
                f"read + to_arrow; {table.num_rows} rows, "
                f"{table.num_columns} columns, {table.nbytes} bytes; "
                f"launches {json.dumps(res['launches'])}")
            check(table.num_rows == len(data), f"{kind}: table rows")
            with open(path, "rb") as f:
                raw = f.read()
            if kind == "exp1":
                head = 2000
                self._same_table(table.slice(0, head),
                                 self._cpu_table(raw[:head * rs], "h.dat",
                                                 **opts), "exp1 head")
                n = table.num_rows
                self._same_table(
                    table.slice(n - self.n_tail, self.n_tail),
                    self._cpu_table(raw[(n - self.n_tail) * rs:], "t.dat",
                                    **opts), "exp1 random tail")
                what = f"the first {head} records and the random tail"
            else:
                k = self.n_check[kind]
                offsets, lengths = self.rdw_walk[kind][1]
                end = offsets[k - 1] + lengths[k - 1]
                self._same_table(table.slice(0, k),
                                 self._cpu_table(raw[:end], "p.dat", **opts),
                                 f"{kind} prefix")
                what = f"the first {k} records"
            log(f"[arrow] {kind}: the table of {what} == device='cpu' read")
            if kind == "exp3":
                self.p11_exp3_table = table  # phase 15's reference
            del data, table, raw

        # (b) the pipelined read's assemble stage, with batch_callback
        for kind, path, opts in files:
            size = os.path.getsize(path)
            runs = []
            for workers in (2, -1):
                got = {}

                def on_batch(i, t, got=got):
                    check(i not in got, f"chunk {i} delivered twice")
                    got[i] = t

                data, secs = self._counted_read(
                    f"arrow_pipeline_{kind}", path, batch_callback=on_batch,
                    pipeline_workers=str(workers),
                    chunk_size_mb=self.pipe_chunk_mb, **opts)
                table = data.to_arrow()
                self._count_arrow(f"arrow_pipeline_{kind}")
                parts = [got[i] for i in sorted(got) if got[i] is not None]
                check(len(parts) == len(data.parts), f"{kind}: "
                      f"{len(parts)} tables delivered for "
                      f"{len(data.parts)} chunks")
                check(pa.concat_tables(parts).equals(
                    table.replace_schema_metadata(None)),
                      f"{kind} workers {workers}: the delivered tables "
                      f"differ from to_arrow()")
                check(table.num_rows == self.arrow[kind]["rows"],
                      f"{kind} workers {workers}: rows")
                report = data.metrics.as_dict()["stage_busy"]
                runs.append(dict(workers=workers, secs=secs,
                                 MBps=size / secs / 1e6,
                                 chunks=len(data.parts),
                                 stage_busy=report))
                log(f"[arrow] {self.card}: {kind} pipelined with assembly, "
                    f"workers {workers}: {secs:.3f} s = "
                    f"{size / secs / 1e6:.1f} MB/s ({len(data.parts)} "
                    f"chunks; stage busy {json.dumps(report)}); phase 9 "
                    f"(same read, no batch_callback): " + " / ".join(
                        f"{r['mb_per_s']:.1f}" for r in self.pipeline[kind]
                        if r["workers"] == workers) + " MB/s")
                del data, table, parts, got
            self.arrow[f"pipeline_{kind}"] = runs
        log("[arrow] delivered tables in index order == to_arrow() minus "
            "its metadata, every read")
        self._arrow_options()
        if not self.rehearsal:
            for k in ARROW_KERNELS:
                check(any(n.get(k) for tag, n in self.launches.items()
                          if tag.startswith(("arrow_", "options_"))),
                      f"{k} never launched on a phase 11 read")

    def _arrow_options(self):
        """Phase 11 (c): an ASCII fixed-length file, the exp1 records
        with record and file offsets, record ids and the input-file-name
        column, and a fixed-length multisegment file, each read on the
        card and held against a device="cpu" read of the same file."""
        np = self.np
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.testing import generators as g

        n_ascii = 60_000 if self.rehearsal else 3_300_000
        n_pad = 2_000 if self.rehearsal else 200_000
        n_seg = 60_000 if self.rehearsal else 2_000_000
        cases = []
        path = os.path.join(self.tmp, "ascii.dat")
        with open(path, "wb") as f:
            for k, start in enumerate(range(0, n_ascii, 500_000)):
                f.write(g.generate_ascii(min(500_000, n_ascii - start),
                                         seed=300 + k).tobytes())
        cases.append(("ascii", path, dict(
            copybook_contents=g.ASCII_COPYBOOK, encoding="ascii")))
        path = os.path.join(self.tmp, "exp1_padded.dat")
        rng = np.random.default_rng(31)
        with open(path, "wb") as f:
            f.write(rng.integers(0, 256, 100, dtype=np.uint8).tobytes())
            for k, start in enumerate(range(0, n_pad, 50_000)):
                body = g.generate_exp1(min(50_000, n_pad - start),
                                       seed=400 + k)
                m = body.shape[0]
                f.write(np.concatenate([
                    rng.integers(0, 256, (m, 4), dtype=np.uint8), body,
                    rng.integers(0, 256, (m, 3), dtype=np.uint8)],
                    axis=1).tobytes())
            f.write(rng.integers(0, 256, 700, dtype=np.uint8).tobytes())
        cases.append(("exp1_offsets", path, dict(
            copybook_contents=g.EXP1_COPYBOOK, record_start_offset="4",
            record_end_offset="3", file_start_offset="100",
            generate_record_id="true", with_input_file_name_col="SRC")))
        path = os.path.join(self.tmp, "segments.dat")
        g.generate_fixed_segments(n_seg, seed=500).tofile(path)
        cases.append(("fixed_segments", path, dict(
            copybook_contents=g.FIXED_SEGMENTS_COPYBOOK,
            **g.FIXED_SEGMENTS_OPTIONS)))
        for kind, path, opts in cases:
            size = os.path.getsize(path)
            data, read_s = self._counted_read(f"options_{kind}", path,
                                              **opts)
            t0 = time.perf_counter()
            table = data.to_arrow()
            arrow_s = time.perf_counter() - t0
            self._count_arrow(f"options_{kind}")
            want = read_cobol(path, device="cpu", **opts).to_arrow()
            self._same_table(table, want, kind)
            res = dict(bytes=size, records=table.num_rows, read_s=read_s,
                       to_arrow_s=arrow_s,
                       MBps=size / (read_s + arrow_s) / 1e6,
                       parts=len(data.parts),
                       launches=self.launches[f"options_{kind}"])
            self.arrow[f"options_{kind}"] = res
            log(f"[arrow] {self.card}: {kind}: {table.num_rows} records "
                f"({size} bytes, {len(data.parts)} parts) read "
                f"{read_s:.3f} s + to_arrow {arrow_s:.3f} s = "
                f"{res['MBps']:.1f} MB/s; launches "
                f"{json.dumps(res['launches'])}; table == device='cpu' "
                f"read")
            os.remove(path)
            del data, table, want

    # -- phase 12: the permissive policies and the generic framings -------

    def _read_row(self, tag, path, size, **opts):
        """`_counted_read` with its rate, framing split, launches and
        ledger counts logged; (data, seconds, record of the read)."""
        data, secs = self._counted_read(tag, path, **opts)
        m = data.metrics.as_dict()
        diag = data.diagnostics
        res = dict(bytes=size, records=len(data), secs=secs,
                   MBps=size / secs / 1e6, framing=m["framing"],
                   shards=m["shards"], launches=self.launches[tag],
                   ledger=(None if diag is None else dict(
                       corrupt_records=diag.corrupt_records,
                       records_dropped=diag.records_dropped,
                       resyncs=diag.resyncs,
                       bytes_skipped=diag.bytes_skipped,
                       entries=len(diag.entries))))
        if m["pipeline"] is not None:
            res["pipeline"] = dict(
                wall_s=m["pipeline"].get("wall_s"),
                overlap=m["pipeline"].get("overlap"),
                stage_busy=m["stage_busy"])
        log(f"[p12] {self.card}: {tag}: {len(data)} records, {size} bytes "
            f"in {secs:.3f} s = {res['MBps']:.1f} MB/s; frame/decode s "
            f"{json.dumps(m['framing'])}; shards {m['shards']}; launches "
            f"{json.dumps(res['launches'])}; ledger "
            f"{json.dumps(res['ledger'])}"
            + (f"; pipeline {json.dumps(res['pipeline'])}"
               if "pipeline" in res else ""))
        self.p12["reads"][tag] = res
        return data, secs, res

    def _fault_sites(self, kind, raw, walk):
        """The fault sites of phase 12 (a) and (b) in the clean file
        `raw` of `walk` (payload offsets, lengths): record indices away
        from the 31,250-record shard edges, and where the first window
        (and, for exp3, the second) ends."""
        np = self.np
        from cobrix_tpu_torch.reader import var_len_reader as vlr

        offsets = np.asarray(walk[0], dtype=np.int64)
        lengths = np.asarray(walk[1], dtype=np.int64)
        starts = offsets - 4
        n = len(starts)
        split = self.p12_split

        def near(byte_pos, before=True):
            """A record index whose header is just before (after)
            `byte_pos`, not within 40 records of a shard edge and not
            the last record of a window."""
            k = int(np.searchsorted(starts, byte_pos)) - (2 if before
                                                           else -1)
            step = -1 if before else 1
            while 3 < k < n - 2 and not (40 < k % split < split - 40):
                k += step
            return max(k, 3)

        w = vlr.READ_WINDOW_BYTES
        ends = offsets + lengths
        # where the second window starts: the first record that does not
        # fit in the first; and the header that the second window's end
        # cuts (the first record that does not fit in it)
        p1 = int(starts[min(n - 1, int(np.searchsorted(
            ends, w, side="right")))])
        p2 = int(starts[min(n - 1, int(np.searchsorted(
            ends, p1 + w, side="right")))])
        return starts, n, p1, p2, near

    def _inject(self, kind, raw, walk):
        """The faulted copy of `raw` and its sites (offsets into the
        faulted bytes, in file order)."""
        from cobrix_tpu_torch.testing import faults

        starts, n, p1, p2, near = self._fault_sites(kind, raw, walk)
        data = bytes(raw)
        sites = []
        if kind == "exp2":
            size = len(raw)
            plan = [("zero", near(p1 - 600)),
                    ("oversized", near(int(size * 0.62))),
                    ("splice", near(int(size * 0.70))),
                    ("bit_flip", near(int(size * 0.78))),
                    ("zero", near(int(size * 0.86))),
                    ("zero", near(int(size * 0.93)))]
            shift = 0
            for what, k in plan:
                at = int(starts[k]) + shift
                if what == "zero":
                    data = faults.zero_rdw(data, at)
                elif what == "oversized":
                    data = faults.oversize_rdw(data, at)
                elif what == "splice":
                    data = faults.splice_garbage(
                        data, at, faults.garbage_run(64, seed=12))
                    shift += 64
                else:
                    data = faults.flip_bit(data, at + 2, 6)
                sites.append((what, at))
            data = faults.truncate(data, len(data) - 23)
            sites.append(("torn_tail", len(data)))
        else:
            # a zeroed header within the resync window of the first
            # window's end, and a garbage run from the last header before
            # the second window's end to 48 bytes past it
            k = near(p1 - 30_000)
            data = faults.zero_rdw(data, int(starts[k]))
            sites.append(("zero", int(starts[k])))
            from cobrix_tpu_torch.reader import var_len_reader as vlr

            edge = p1 + vlr.READ_WINDOW_BYTES
            data = faults.overwrite(data, p2, faults.garbage_run(
                edge - p2 + 48, seed=13))
            sites.append(("garbage_run", p2))
        return data, sites, p1, p2

    def phase_recovery(self):
        """Phase 12 (a)-(c): the permissive policies on the faulted exp2
        and exp3 files and the torn exp1 file, and their cost on the
        clean ones."""
        np = self.np
        from cobrix_tpu_torch.reader.diagnostics import (
            FramingError, ReadDiagnostics, RecordErrorPolicy)
        from cobrix_tpu_torch.reader.recovery import rdw_scan_permissive
        from cobrix_tpu_torch.reader import var_len_reader as vlr
        from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                         EXP2_COPYBOOK,
                                                         EXP3_COPYBOOK)

        t_phase = time.perf_counter()
        self.p12 = {"reads": {}}
        self.p12_split = 500 if self.rehearsal else 31_250
        if self.rehearsal:
            vlr.READ_WINDOW_BYTES = 64 * 1024  # several windows
        self._policy_cost(EXP1_COPYBOOK, EXP2_COPYBOOK, EXP3_COPYBOOK)
        for kind, cb in (("exp2", EXP2_COPYBOOK), ("exp3", EXP3_COPYBOOK)):
            raw, walk = self.rdw_walk[kind]
            data, sites, p1, p2 = self._inject(kind, raw, walk)
            path = os.path.join(self.tmp, f"{kind}_faults.dat")
            with open(path, "wb") as f:
                f.write(data)
            size = len(data)
            log(f"[p12] {kind}: {size} bytes, sites "
                f"{json.dumps(sites)}; first window ends at {p1}, the "
                f"second at {p2}")
            opts = dict(copybook_contents=cb, **P12_RDW)
            # fail_fast: the first site's offset and snapshot
            try:
                self._counted_read(f"p12_{kind}_fail_fast", path, **opts)
                raise SmokeFailure(f"{kind}: fail_fast read a faulted file")
            except FramingError as e:
                check(e.offset == sites[0][1] and "00 00 00 00" in str(e),
                      f"{kind} fail_fast: {e} (offset {e.offset}, first "
                      f"site {sites[0][1]})")
                log(f"[p12] {kind} fail_fast raised at {e.offset}: {e}")
            for policy in ("permissive", "drop_malformed"):
                pol = RecordErrorPolicy(policy)
                # the device framing against the plain permissive scan
                plain = ReadDiagnostics()
                t0 = time.perf_counter()
                want = rdw_scan_permissive(data, False, 0, 0, 0, pol,
                                           65536, plain, path)
                plain_s = time.perf_counter() - t0
                ledger, reasons, offs, lens = ReadDiagnostics(), {}, [], []
                self.sync()
                t0 = time.perf_counter()
                with open(path, "rb") as f:
                    for base, _, o, ln in vlr.frame_windows(
                            f, size, self.device, False, 0, policy=pol,
                            ledger=ledger, file_name=path,
                            corrupt_reasons=reasons):
                        offs.append(base + o.cpu().numpy())
                        lens.append(ln.cpu().numpy())
                card_s = time.perf_counter() - t0
                check(np.array_equal(np.concatenate(offs), want[0])
                      and np.array_equal(np.concatenate(lens), want[1])
                      and reasons == want[2]
                      and ledger.to_json() == plain.to_json(),
                      f"{kind} {policy}: device framing differs from the "
                      f"plain permissive scan")
                log(f"[p12] {kind} {policy}: device framing {card_s:.3f} s "
                    f"== plain rdw_scan_permissive {plain_s:.3f} s "
                    f"(offsets, lengths, reasons, ledger: "
                    f"{plain.resyncs} resyncs, {plain.bytes_skipped} bytes "
                    f"skipped, {len(plain.entries)} entries)")
                popts = dict(opts, record_error_policy=policy)
                if policy == "permissive":
                    popts["corrupt_record_column"] = "_corrupt_record"
                whole, _, _ = self._read_row(
                    f"p12_{kind}_{policy}", path, size,
                    enable_indexes="false", **popts)
                check(whole.diagnostics.to_json() == plain.to_json(),
                      f"{kind} {policy}: the read's ledger differs from the "
                      f"plain scan's")
                check(len(whole) == len(want[0]), f"{kind} {policy}: rows")
                table = whole.to_arrow()
                self._held_rows(kind, data, want[0], plain, table, popts,
                                sites)
                runs = []
                for workers in (0, 2):
                    got, _, _ = self._read_row(
                        f"p12_{kind}_{policy}_split_w{workers}", path,
                        size, pipeline_workers=str(workers),
                        input_split_records=str(self.p12_split), **popts)
                    runs.append(got)
                    check(got.to_arrow().replace_schema_metadata(None)
                          .equals(table.replace_schema_metadata(None)),
                          f"{kind} {policy} workers {workers}: rows differ "
                          f"from the whole-file read")
                    a, b = got.diagnostics.as_dict(), plain.as_dict()
                    strip = lambda d: [dict(e, record_index=None)
                                       for e in d["entries"]]
                    check(strip(a) == strip(b) and all(
                        a[k] == b[k] for k in ("corrupt_records",
                                               "records_dropped",
                                               "bytes_skipped", "resyncs")),
                          f"{kind} {policy} workers {workers}: ledger")
                check(runs[0].diagnostics.to_json()
                      == runs[1].diagnostics.to_json(),
                      f"{kind} {policy}: pipelined ledger != sequential")
                log(f"[p12] {kind} {policy}: pipelined (2 workers) == "
                    f"sequential, {self.p12_split}-record shards: tables "
                    f"and ledgers; == the whole-file read's rows and "
                    f"ledger entries")
                del whole, table, runs, got
            os.remove(path)
        self._torn_exp1(EXP1_COPYBOOK)
        log(f"[p12] (a)-(c) and the policies' cost: "
            f"{time.perf_counter() - t_phase:.1f} s")

    def _held_rows(self, kind, data, offsets, plain, table, opts, sites):
        """Rows within 3 records of every ledger entry, the first and
        last 1,000 rows, and each entry, against device="cpu" reads of
        the records around them (slices of `data` from a record header:
        `offsets` are the plain scan's payload offsets)."""
        np = self.np
        from cobrix_tpu_torch import read_cobol

        n = len(offsets)
        starts = np.asarray(offsets) - 4
        first = min(1000, n)
        spans = [(0, first), (max(0, n - first), n)]
        for at in [e.offset for e in plain.entries] + [s for _, s in sites]:
            k = int(np.searchsorted(starts, at))
            spans.append((max(0, k - 3), min(n, k + 3)))
        held = 0
        for lo, hi in spans:
            # the slice reaches 10 records past the span (the resync
            # chains through 3), or the end of the file
            end = (len(data) if hi + 10 >= n
                   else int(starts[hi + 10]))
            name = os.path.join(self.tmp, "slice.dat")
            with open(name, "wb") as f:
                f.write(data[int(starts[lo]):end])
            cpu = read_cobol(name, device="cpu", **opts)
            want = cpu.to_arrow()
            self._same_table(
                table.slice(lo, hi - lo).replace_schema_metadata(None),
                want.slice(0, hi - lo).replace_schema_metadata(None),
                f"{kind} rows {lo}-{hi}")
            base = int(starts[lo])
            mine = [e for e in plain.entries
                    if base <= e.offset < end - (0 if end == len(data)
                                                 else 1)]
            theirs = [(e.offset + base, e.length, e.reason,
                       e.header_snapshot) for e in cpu.diagnostics.entries]
            check(theirs[:len(mine)] == [(e.offset, e.length, e.reason,
                                          e.header_snapshot)
                                         for e in mine],
                  f"{kind} rows {lo}-{hi}: ledger entries differ from the "
                  f"CPU read's")
            held += hi - lo
            os.remove(name)
        log(f"[p12] {kind}: {held} rows around {len(sites)} fault sites "
            f"and {len(plain.entries)} ledger entries, the first and last "
            f"{first} == device='cpu' reads of their records; entries == "
            f"the CPU reads'")

    def _torn_exp1(self, cb):
        """Phase 12 (c): the exp1 file with a 700-byte torn tail, under
        the three policies."""
        from cobrix_tpu_torch.reader.diagnostics import hex_snapshot

        rs = 1493
        path = self.exp1_path
        tail = self.np.random.default_rng(41).integers(
            0, 256, 700, dtype=self.np.uint8).tobytes()
        with open(path, "ab") as f:
            f.write(tail)
        size = os.path.getsize(path)
        n = size // rs
        opts = dict(copybook_contents=cb)
        try:
            self._counted_read("p12_exp1_fail_fast", path,
                               record_error_policy="fail_fast", **opts)
            raise SmokeFailure("exp1: fail_fast read a torn file")
        except ValueError as e:
            check("permissive" in str(e), f"exp1 fail_fast: {e}")
            log(f"[p12] exp1 fail_fast raised: {e}")
        with open(path, "rb") as f:
            f.seek((n - 1000) * rs)
            last = f.read()
        for policy in ("permissive", "drop_malformed"):
            data, _, _ = self._read_row(
                f"p12_exp1_{policy}", path, size, record_error_policy=policy,
                corrupt_record_column="_bad", **opts)
            keep = policy == "permissive"
            check(len(data) == n + keep, f"exp1 {policy}: {len(data)} rows")
            (e,) = data.diagnostics.entries
            check((e.offset, e.record_index, e.header_snapshot)
                  == (n * rs, n if keep else None, hex_snapshot(tail[:16]))
                  and data.diagnostics.records_dropped == (not keep),
                  f"exp1 {policy}: ledger {data.diagnostics.to_json()}")
            popts = dict(opts, record_error_policy=policy,
                         corrupt_record_column="_bad")
            want = self._cpu_table(last, "t.dat", **popts
                                   ).replace_schema_metadata(None)
            k = want.num_rows
            got = self._rows_at(data, len(data) - k, len(data))
            self._same_table(got, want, f"exp1 {policy} last rows")
            check(got.column("_bad")[k - 1].as_py()
                  == (e.reason if keep else None),
                  f"exp1 {policy}: the last row's reason")
            log(f"[p12] exp1 {policy}: {len(data)} rows; the last {k} == "
                f"device='cpu' read; ledger {json.dumps(e.as_dict())}")
            del data

    def _policy_cost(self, cb1, cb2, cb3):
        """Permissive against fail_fast on the clean exp2, exp3 and exp1
        files, in turns: the same scan launches (one a window)."""
        cost = {}
        for kind, path, cb, extra in [
                ("exp2", self.rdw_files["exp2"], cb2, P12_RDW),
                ("exp3", self.rdw_files["exp3"], cb3, P12_RDW),
                ("exp1", self.exp1_path, cb1, {})]:
            size = os.path.getsize(path)
            runs = []
            for policy in ("fail_fast", "permissive", "permissive",
                           "fail_fast"):
                _, _, res = self._read_row(
                    f"p12_cost_{kind}_{policy}_{len(runs)}", path, size,
                    copybook_contents=cb, record_error_policy=policy,
                    **extra)
                runs.append(dict(policy=policy, **res))
            scans = {r["launches"].get("rdw_scan", 0) for r in runs}
            check(len(scans) == 1, f"{kind}: scan launches differ between "
                  f"the policies: {[r['launches'] for r in runs]}")
            cost[kind] = runs
            log(f"[p12] {self.card}: {kind} clean MB/s fail_fast / "
                f"permissive / permissive / fail_fast: " + " / ".join(
                    f"{r['MBps']:.1f}" for r in runs)
                + f"; scan launches {scans.pop()} each")
        self.p12["cost"] = cost

    def phase_generic(self):
        """Phase 12 (d): the generic per-record framings, framed on the
        host and decoded on the card; the rows of the first and last
        1,000 records against device="cpu" reads of them."""
        np = self.np
        from cobrix_tpu_torch.testing import generators as g

        t_phase = time.perf_counter()
        r = self.rehearsal
        cases = []
        # exp3 with big-endian RDWs read through a record-length field:
        # the phase 4 file's first records, their headers turned around
        raw, (offsets, lengths) = self.rdw_walk["exp3"]
        n3 = 300 if r else 50_000
        starts = np.asarray(offsets[:n3], dtype=np.int64) - 4
        end = int(offsets[n3 - 1] + lengths[n3 - 1])
        arr = np.frombuffer(raw[:end], dtype=np.uint8).copy()
        hdr = arr[starts[:, None] + np.arange(4)]
        arr[starts[:, None] + np.arange(4)] = hdr[:, [3, 2, 1, 0]]
        bounds = np.append(starts, end)
        opts = dict(copybook_contents=g.LENGTH_FIELD_EXP3_COPYBOOK,
                    record_length_field="RECORD-LENGTH", rdw_adjustment="4",
                    **P12_SEG)
        cases.append(("exp3_length_field", arr.tobytes(), bounds, opts, []))
        # three length fields broken: two records that read as one with
        # their successor, and a last record that declares 65,535 bytes
        bad = arr.copy()
        for k in (n3 // 3, (2 * n3) // 3):
            merged = int(bounds[k + 2] - bounds[k]) - 4
            bad[bounds[k]:bounds[k] + 2] = [merged >> 8, merged & 0xFF]
        bad[bounds[n3 - 1]:bounds[n3 - 1] + 2] = [0xFF, 0xFF]
        bad_bounds = np.delete(bounds, [n3 // 3 + 1, (2 * n3) // 3 + 1])
        cases.append(("exp3_length_field_permissive", bad.tobytes(),
                      bad_bounds, dict(opts, record_error_policy="permissive",
                                       corrupt_record_column="_corrupt"),
                      [n3 // 3, (2 * n3) // 3 - 1]))
        # text lines, LF and CRLF mixed, trailing blanks cut (cut from
        # 1,000,000, with the custom records and the OCCURS table below,
        # to keep the whole run inside its time)
        nt = 3000 if r else 250_000
        text = g.generate_text(nt, seed=42)
        nl = np.nonzero(np.frombuffer(text, dtype=np.uint8) == 0x0A)[0]
        cases.append(("text", text, np.append(0, nl + 1),
                      dict(copybook_contents=g.TEXT_COPYBOOK,
                           is_text="true", encoding="ascii"), []))
        # records behind a custom 5-byte header, written by children
        nc = 3000 if r else 250_000
        crdw = self._write_custom_rdw(nc)
        valid, pos, view = [], 0, memoryview(crdw)
        while pos + 5 <= len(crdw):
            if view[pos] == 1:
                valid.append(pos)
            pos += 5 + view[pos + 3] + 256 * view[pos + 4]
        cbounds = np.asarray(valid + [len(crdw)], dtype=np.int64)
        custom = "cobrix_tpu_torch.testing.custom_framing."
        cases.append(("custom_header_parser", crdw, cbounds, dict(
            copybook_contents=g.CUSTOM_RDW_COPYBOOK,
            is_record_sequence="true",
            record_header_parser=custom + "CustomRdw5ByteParser",
            rhp_additional_info="chip_smoke", **P12_SEG), []))
        cases.append(("custom_record_extractor", crdw, cbounds, dict(
            copybook_contents=g.CUSTOM_RDW_COPYBOOK,
            record_extractor=custom + "CustomRdw5ByteExtractor",
            re_additional_info="chip_smoke", **P12_SEG), []))
        # variable-size OCCURS: a trailing 1 TO 2000 table
        nv = 40 if r else 6_000
        vo = g.generate_var_occurs(nv, seed=43)
        vb, pos = [], 0
        while pos < len(vo):
            vb.append(pos)
            pos += g.VAR_OCCURS_HEAD + 8 * int.from_bytes(
                vo[pos + 59:pos + 61], "big")
        cases.append(("variable_size_occurs", vo,
                      np.asarray(vb + [len(vo)], dtype=np.int64),
                      dict(copybook_contents=g.VAR_OCCURS_COPYBOOK,
                           variable_size_occurs="true"), []))
        for kind, data, bounds, opts, sites in cases:
            path = os.path.join(self.tmp, f"{kind}.dat")
            with open(path, "wb") as f:
                f.write(data)
            got, _, res = self._read_row(f"p12_{kind}", path, len(data),
                                         **opts)
            n = len(bounds) - 1
            check(len(got) == n - ("drop" in opts.get(
                "record_error_policy", "")),
                  f"{kind}: {len(got)} rows for {n} records")
            k = min(1000, n)
            schema = got.output_schema
            first = got.parts[0].to_arrow(schema)
            last = got.parts[-1].to_arrow(schema)
            spans = [("first", 0, k, first.slice(0, k)),
                     ("last", n - k, n, last.slice(last.num_rows - k, k))]
            spans += [(f"around record {at}", at - 3, at + 3,
                       self._rows_at(got, at - 3, at + 3)) for at in sites]
            for what, lo, hi, table in spans:
                want = self._cpu_table(
                    data[int(bounds[lo]):int(bounds[hi])], "g.dat", **opts)
                self._same_table(table, want.replace_schema_metadata(None),
                                 f"{kind} {what} {k} rows")
            if got.diagnostics is not None:
                check(got.diagnostics.corrupt_records >= 1,
                      f"{kind}: the truncated last record is not ledgered")
                check(last.column("_corrupt")[last.num_rows - 1].as_py()
                      is not None, f"{kind}: the last row has no reason")
            check(res["launches"].get("pack_records", 0) > 0 or r,
                  f"{kind}: the pack kernel never launched")
            log(f"[p12] {kind}: the first and last {k} rows"
                + "".join(f", the 6 around record {at}" for at in sites)
                + " == device='cpu' reads of those records")
            os.remove(path)
            del got, first, last
        log(f"[p12] (d): {time.perf_counter() - t_phase:.1f} s")

    def _rows_at(self, data, lo, hi):
        """The table of rows [lo, hi) of a read, from the parts that hold
        them."""
        import pyarrow as pa

        tables, first = [], 0
        for part in data.parts:
            count = part.n_rows
            if first < hi and lo < first + count:
                t = part.to_arrow(data.output_schema)
                a, b = max(lo, first) - first, min(hi, first + count) - first
                tables.append(t.slice(a, b - a))
            first += count
        return pa.concat_tables(tables)

    def _write_custom_rdw(self, n):
        """`generate_custom_rdw` records, written by child interpreters
        side by side (`_write_rdw`), as bytes."""
        path = self._write_rdw("custom_rdw", n, 700)
        with open(path, "rb") as f:
            data = f.read()
        os.remove(path)
        return data


    # -- phase 13: hierarchical reads and the host row walk ---------------

    def _p13_read(self, tag, path, size, walk=False, **opts):
        """read_cobol on the default device, then ``to_arrow``, each
        read kernel's launches counted from 0 over the read; logs MB/s
        over read + to_arrow, the frame / decode / assemble seconds, the
        launches, the peak device memory, the host RSS after it (and the
        process's peak so far) and ``assembly_stats``. `walk`: the host row walk,
        which launches no kernel. (data, table, record of the read)."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import fused_decode
        from cobrix_tpu_torch.reader.hierarchical_arrow import assembly_stats

        counters = {"fused_decode": fused_decode, "rdw_scan": df.scan_window,
                    "pack_records": df.pack_records}
        for fn in asm.KERNELS.values():
            fn.launches = 0
        kw = {"device": "cpu"} if self.rehearsal else {}
        if not self.rehearsal:
            self.torch.cuda.reset_peak_memory_stats()
        assembly_stats(reset=True)
        for fn in counters.values():
            fn.launches = 0
        self.sync()
        t0 = time.perf_counter()
        data = read_cobol(path, **opts, **kw)
        self.sync()
        read_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        table = data.to_arrow()
        arrow_s = time.perf_counter() - t0
        # the assembly kernels launch in to_arrow, or in the pipelined
        # read's assemble stage
        launches.update((k, fn.launches) for k, fn in asm.KERNELS.items())
        self.launches[tag] = {k: v for k, v in launches.items()
                              if v or k == "fused_decode"}
        if not self.rehearsal and not walk:
            for k, v in launches.items():
                check(v > 0 or k in ARROW_KERNELS[1:],
                      f"{k} never launched on the {tag} read")
        m = data.metrics.as_dict()
        peak_dev = (None if self.rehearsal
                    else self.torch.cuda.max_memory_allocated())
        rss = None
        try:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            pass
        # the process's peak so far (ru_maxrss is in KiB on Linux)
        hwm = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        busy = m["stage_busy"] or {}
        res = dict(bytes=size, rows=len(data), read_s=read_s,
                   to_arrow_s=arrow_s,
                   MBps=size / (read_s + arrow_s) / 1e6,
                   rows_per_s=len(data) / (read_s + arrow_s),
                   framing=m["framing"], assemble_s=busy.get(
                       "assemble", arrow_s),
                   stage_busy=busy or None, shards=m["shards"],
                   launches=launches, peak_device_bytes=peak_dev,
                   host_rss_bytes=rss, peak_host_rss_bytes=hwm,
                   assembly=assembly_stats())
        log(f"[p13] {self.card}: {tag}: {len(data)} rows from {size} bytes: "
            f"read {read_s:.3f} s + to_arrow {arrow_s:.3f} s = "
            f"{res['MBps']:.1f} MB/s, {res['rows_per_s']:.0f} rows/s; "
            f"frame/decode s {json.dumps(m['framing'])}; stage busy "
            f"{json.dumps(busy)}; shards {m['shards']}; launches "
            f"{json.dumps(launches)}; peak device {peak_dev} B, host RSS "
            f"{rss} B after (process peak {hwm} B); assembly_stats "
            f"{json.dumps(res['assembly'])}")
        self.p13["reads"][tag] = res
        return data, table, res

    def _p13_columnar(self, res, tag):
        bails = {k: v for k, v in res["assembly"].items()
                 if k != "columnar" and v}
        check(res["assembly"]["columnar"] >= 1 and not bails,
              f"{tag}: assembly_stats {res['assembly']}, not the columnar "
              f"route")

    def _p13_cpu(self, raw, name, **opts):
        """A device="cpu" read of the bytes `raw` (data, table)."""
        from cobrix_tpu_torch import read_cobol

        path = os.path.join(self.tmp, name)
        with open(path, "wb") as f:
            f.write(raw)
        try:
            data = read_cobol(path, device="cpu", **opts)
            return data, data.to_arrow()
        finally:
            os.remove(path)

    def _p13_ids_aside(self, table):
        return table.drop_columns([c for c in ("File_Id", "Record_Id")
                                   if c in table.column_names])

    def _p13_seven_options(self, g):
        """The 7-segment hierarchy's options (TestDataGen17Hierarchical):
        its segment ids, their redefines and the parent of each child."""
        return dict(
            copybook_contents=g.HIERARCHICAL_COPYBOOK,
            is_record_sequence="true", segment_field="SEGMENT-ID",
            generate_record_id="true",
            **{f"redefine_segment_id_map:{i}": f"{name} => {sid}"
               for i, (sid, name) in enumerate(
                   g.HIERARCHICAL_SEGMENT_MAP.items())},
            **{f"segment-children:{i}": f"{parent} => {child}"
               for i, (child, parent) in enumerate(
                   g.HIERARCHICAL_PARENT_MAP.items())})

    def phase_hierarchical(self):
        """Phase 13: (a) the exp3 file as a hierarchy (CONTACTS under
        STATIC-DETAILS), decoded once on the card; (b) the 7-segment
        hierarchy across a 64 MiB window; (c) the host row walk."""
        t_phase = time.perf_counter()
        self.p13 = {"reads": {}}
        self._p13_exp3()
        self._p13_seven()
        self._p13_walk()
        self.p13["secs"] = time.perf_counter() - t_phase
        log(f"[p13] phase 13: {self.p13['secs']:.1f} s")

    def _p13_exp3(self):
        np = self.np
        import pyarrow as pa
        from cobrix_tpu_torch.reader.arrow_out import rows_to_table
        from cobrix_tpu_torch.testing.generators import EXP3_COPYBOOK

        t0 = time.perf_counter()
        path = self.rdw_files["exp3"]
        raw, (offsets, lengths) = self.rdw_walk["exp3"]
        size = len(raw)
        offsets = np.asarray(offsets, dtype=np.int64)
        starts = np.append(offsets - 4, size)
        opts = dict(copybook_contents=EXP3_COPYBOOK, **P13_EXP3)
        seq, table, res = self._p13_read("p13_exp3", path, size, **opts)
        self._p13_columnar(res, "exp3")
        pip, ptable, pres = self._p13_read(
            "p13_exp3_pipelined", path, size, pipeline_workers="2",
            chunk_size_mb=self.pipe_chunk_mb, **opts)
        self._p13_columnar(pres, "exp3 pipelined")
        check(ptable.equals(table), "exp3: the pipelined table differs from "
              "the sequential one")
        # the roots ('C' records) and the flush-trigger Record_Ids
        ids = np.frombuffer(raw, dtype=np.uint8)[offsets]
        roots = np.nonzero(ids == 0xC3)[0]
        n = len(offsets)
        check(table.num_rows == len(roots) == len(seq),
              f"exp3: {table.num_rows} rows for {len(roots)} roots")
        want_ids = np.append(roots[1:], n)
        check(np.array_equal(table.column("Record_Id").to_numpy(), want_ids),
              "exp3: Record_Id is not the flush trigger's record index")
        k = min(500, len(roots))
        spans = [("first", 0, k, 0, int(starts[roots[k]]) if k < len(roots)
                  else size),
                 ("last", len(roots) - k, len(roots),
                  int(starts[roots[-k]]), size)]
        for what, lo, hi, a, b in spans:
            _, want = self._p13_cpu(raw[a:b], "p13s.dat", **opts)
            self._same_table(self._p13_ids_aside(table.slice(lo, hi - lo)),
                             self._p13_ids_aside(want),
                             f"exp3 {what} {k} roots")
        log(f"[p13] exp3: pipelined table == sequential; Record_Id == the "
            f"flush trigger's index; the first and last {k} roots == "
            f"device='cpu' reads of those records")
        # to_rows of a prefix: the nesting walk against the table and the
        # CPU read
        m = min(3000, n)
        prefix = raw[:int(starts[m])]
        ppath = os.path.join(self.tmp, "p13p.dat")
        with open(ppath, "wb") as f:
            f.write(prefix)
        got, gtable, _ = self._p13_read("p13_exp3_prefix", ppath,
                                        len(prefix), **opts)
        t1 = time.perf_counter()
        rows = got.to_rows()
        rows_s = time.perf_counter() - t1
        os.remove(ppath)
        check(rows_to_table(rows, got.schema).equals(gtable),
              "exp3 prefix: to_rows differs from to_arrow")
        cpu, ctable = self._p13_cpu(prefix, "p13c.dat", **opts)
        check(rows == cpu.to_rows(), "exp3 prefix: rows differ from the "
              "device='cpu' read")
        self._same_table(gtable, ctable, "exp3 prefix table")
        log(f"[p13] exp3: to_rows of {m} records ({len(rows)} roots) in "
            f"{rows_s:.3f} s == to_arrow() == device='cpu' read; (a) "
            f"{time.perf_counter() - t0:.1f} s")
        del seq, table, pip, ptable, got, gtable, cpu, ctable, rows

    def _p13_seven(self):
        np = self.np
        from cobrix_tpu_torch.reader import var_len_reader as vlr
        from cobrix_tpu_torch.reader.json_out import rows_to_json
        from cobrix_tpu_torch.testing import generators as g

        t0 = time.perf_counter()
        companies = 600 if self.rehearsal else 60_000
        path = self._write_rdw("hierarchical", companies, 100)
        with open(path, "rb") as f:
            raw = f.read()
        size = len(raw)
        offsets, lengths = host_walk(raw)
        offsets = np.asarray(offsets, dtype=np.int64)
        starts = np.append(offsets - 4, size)
        sids = np.frombuffer(raw, dtype=np.uint8)[offsets]
        roots = np.nonzero(sids == 0xF1)[0]
        ends = np.append(starts[roots[1:]], size)
        window = vlr.READ_WINDOW_BYTES
        crossing = [int(r) for r, a, b in zip(roots, starts[roots], ends)
                    if a // window != (b - 1) // window]
        check(bool(crossing), "the 7-segment file has no root whose "
              "children cross a window's end")
        log(f"[p13] wrote {companies} companies, {len(offsets)} records "
            f"({size} bytes) in {time.perf_counter() - t0:.1f} s; root "
            f"{crossing[0]} has children on both sides of byte {window}")
        opts = self._p13_seven_options(g)
        seq, table, res = self._p13_read("p13_seven", path, size, **opts)
        self._p13_columnar(res, "7-segment")
        # rows and JSON lines: of the first `prefix_roots` companies
        # (their nesting walk takes about 0.4 ms a row)
        prefix_roots = min(len(roots), 50 if self.rehearsal else 5_000)
        cut = (int(starts[roots[prefix_roots]])
               if prefix_roots < len(roots) else size)
        ppath = os.path.join(self.tmp, "p13hp.dat")
        with open(ppath, "wb") as f:
            f.write(raw[:cut])
        pre, _, _ = self._p13_read("p13_seven_prefix", ppath, cut, **opts)
        os.remove(ppath)
        t1 = time.perf_counter()
        rows = pre.to_rows()
        lines = pre.to_json_lines()
        rows_s = time.perf_counter() - t1
        split = "500" if self.rehearsal else "200000"
        pip, ptable, pres = self._p13_read(
            "p13_seven_pipelined", path, size, pipeline_workers="2",
            input_split_records=split, **opts)
        self._p13_columnar(pres, "7-segment pipelined")
        check(ptable.equals(table), "7-segment: the pipelined table differs "
              "from the sequential one")
        cpu, ctable = self._p13_cpu(raw, "p13h.dat", **opts)
        self._same_table(table, ctable, "7-segment table")
        cpu_pre, _ = self._p13_cpu(raw[:cut], "p13hc.dat", **opts)
        cpu_rows = cpu_pre.to_rows()
        check(rows == cpu_rows, "7-segment prefix: rows differ from the "
              "device='cpu' read")
        # JSON lines: the CPU read's of the prefix's first and last 2,000
        # rows (rows_to_json is what to_json_lines runs over the rows);
        # the crossing root's nesting is in the whole file's table
        j = min(2000, len(rows))
        for lo, hi in ((0, j), (len(rows) - j, len(rows))):
            check(lines[lo:hi] == rows_to_json(cpu_rows[lo:hi],
                                               cpu_pre.schema),
                  f"7-segment: JSON lines {lo}-{hi} differ from the "
                  f"device='cpu' read's")
        log(f"[p13] 7-segment: to_rows + to_json_lines of the first "
            f"{prefix_roots} companies {rows_s:.3f} s; {len(rows)} rows; "
            f"pipelined ({pres['shards']} shards) table == sequential; "
            f"table == device='cpu' read (the crossing root's too), the "
            f"prefix's rows and JSON lines of its first and last rows "
            f"too; (b) {time.perf_counter() - t0:.1f} s")
        self.p13["seven"] = dict(companies=companies, records=len(offsets),
                                 bytes=size, crossing_root=crossing[0],
                                 prefix_companies=prefix_roots,
                                 rows_and_json_s=rows_s)
        self.p13_seven_raw = (raw, starts, roots)
        os.remove(path)
        del seq, table, pip, ptable, cpu, ctable, rows, lines, cpu_rows, pre

    def _p13_walk(self):
        np = self.np
        from cobrix_tpu_torch.testing import generators as g

        t0 = time.perf_counter()
        raw, starts, roots = self.p13_seven_raw
        del self.p13_seven_raw
        k = 50 if self.rehearsal else 5000
        cut = raw[:int(starts[roots[k]])]
        path = os.path.join(self.tmp, "p13w.dat")
        with open(path, "wb") as f:
            f.write(cut)
        opts = dict(self._p13_seven_options(g),
                    select="COMPANY-NAME,CUSTOMER-NAME")
        got, table, res = self._p13_read("p13_walk_select", path, len(cut),
                                         walk=True, **opts)
        os.remove(path)
        check(res["assembly"]["columnar"] == 0, "the select read did not "
              "take the row walk")
        cpu, ctable = self._p13_cpu(cut, "p13wc.dat", **opts)
        check(got.to_rows() == cpu.to_rows(), "row walk (select): rows "
              "differ from the device='cpu' read")
        self._same_table(table, ctable, "row walk (select) table")
        log(f"[p13] row walk (select, {k} companies): rows and table == "
            f"device='cpu' read")
        del got, table, cpu, ctable
        # a DEPENDING ON table followed by a trailer: the first and last
        # 1,000 rows against CPU reads of those records
        n = 400 if self.rehearsal else 100_000
        data = g.generate_dynamic_occurs(n, seed=44)
        bounds, pos = [], 0
        while pos < len(data):
            bounds.append(pos)
            pos += 28 + 8 * int.from_bytes(data[pos + 20:pos + 22], "big")
        bounds.append(len(data))
        path = os.path.join(self.tmp, "p13d.dat")
        with open(path, "wb") as f:
            f.write(data)
        opts = dict(copybook_contents=g.DYNAMIC_OCCURS_COPYBOOK,
                    variable_size_occurs="true")
        got, table, res = self._p13_read("p13_walk_dynamic_occurs", path,
                                         len(data), walk=True, **opts)
        os.remove(path)
        check(len(got) == n, f"dynamic OCCURS: {len(got)} rows for {n}")
        m = min(1000, n)
        rows = got.to_rows()
        for what, lo, hi in (("first", 0, m), ("last", n - m, n)):
            cpu, _ = self._p13_cpu(data[bounds[lo]:bounds[hi]], "p13dc.dat",
                                   **opts)
            check(rows[lo:hi] == cpu.to_rows(), f"dynamic OCCURS: the "
                  f"{what} {m} rows differ from the device='cpu' read")
        log(f"[p13] row walk (dynamic OCCURS, {n} records): the first and "
            f"last {m} rows == device='cpu' reads; (c) "
            f"{time.perf_counter() - t0:.1f} s")
        del got, table, rows

    # -- phase 14: the Arrow assembly on the card --------------------------

    def _asm_steps(self, src, aux, plan):
        """The assembly's three steps: (kernel, its wrapper and plain
        version, whether the plan runs it, a call over a state). The
        lengths kernel's plain version is `str_lengths_plain`, then
        `str_offsets_plain`."""
        from cobrix_tpu_torch.ops import arrow_assemble as asm

        return [
            ("arrow_scalars", asm.scalars, asm.scalars_plain,
             plan.num_tiles > 0, lambda f, st: f(src, aux, plan, st[0])),
            ("arrow_str_lengths", asm.str_lengths,
             asm.str_lengths_and_offsets_plain, plan.str_tiles > 0,
             lambda f, st: f(src, aux, plan, st[0], st[1], st[2])),
            ("arrow_str_copy", asm.str_copy, asm.str_copy_plain,
             plan.str_tiles > 0,
             lambda f, st: f(src, aux, plan, st[0], st[1]))]

    def _hold_assembly(self, plan, what):
        """Each step's kernel against its plain version from the same
        state, every byte of the output buffer and the tile bases (the
        lengths kernel's look-back scratch, its status words and two
        counters, is its own and is not compared); the next step starts
        from the kernel's state."""
        from cobrix_tpu_torch.ops import arrow_assemble as asm

        src, aux = asm.upload(plan)
        state = asm.new_state(plan, self.device)
        held = []
        for name, kernel, plain, runs, call in self._asm_steps(src, aux,
                                                               plan):
            if not runs:
                continue
            want = tuple(t.clone() for t in state)
            call(kernel, state)
            call(plain, want)
            for a, b, part in zip(state, want,
                                  ("output buffer", "tile bases")):
                self.same_on_card(a, b, f"{what}: {name} {part}", name)
            held.append(name)
        return held

    def _batch_plan(self, batch, active, policy):
        """The assembly plan of one decoded batch's table: the requests
        of the builder's walk over the batch's own host buffer."""
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.reader.arrow_out import ArrowBatchBuilder

        builder = ArrowBatchBuilder(batch, active)
        builder.request_body(policy)
        return asm.build_plan(builder.leaves.requests, batch.host_buffer,
                              batch.decoder.device)

    def _captured_plans(self, read):
        """The plans of every assembly `read()` runs (its tables' leaves,
        a hierarchy's masked and positioned ones included)."""
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.reader import arrow_out

        seen = []
        real = arrow_out._Leaves.run

        def run(leaves):
            if leaves.requests:
                seen.append(leaves)
            return real(leaves)
        arrow_out._Leaves.run = run
        try:
            read()
        finally:
            arrow_out._Leaves.run = real
        return [asm.build_plan(l.requests, l.batch.host_buffer,
                               l.batch.decoder.device) for l in seen]

    def phase_assembly(self):
        """Phase 14: (a) the assembly's kernels against their plain
        version, (c) their times beside the bound, (d) `parallelism`
        (see the module docstring)."""
        t_phase = time.perf_counter()
        self.asm14 = {"held": {}}
        self._p14_hold()
        self._p14_times()
        self._p14_split()
        self._p14_parallelism()
        self.asm14["secs"] = time.perf_counter() - t_phase
        log(f"[p14] phase 14: {self.asm14['secs']:.1f} s")

    def _p14_hold(self):
        np = self.np
        from cobrix_tpu_torch import ColumnarDecoder, parse_copybook
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.copybook.datatypes import SchemaRetentionPolicy
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.testing import arrow_cases
        from cobrix_tpu_torch.testing import generators as g

        t0 = time.perf_counter()
        held = {k: 0 for k in ARROW_KERNELS}
        pin = not self.rehearsal
        cases = [(f"grid of {n} rows", n, 3)
                 for n in (1, 31, 32, 33, 257, 4097)]
        cases.append(("grid of an exp1 chunk's 44,949 rows"
                      if not self.rehearsal else "grid of 600 rows",
                      600 if self.rehearsal else 44_949, 3))
        cases.append(("grid of 257 rows, 2,000 slots", 257,
                      20 if self.rehearsal else 2_000))
        for what, n, slots in cases:
            requests, buf = arrow_cases.grid(n, seed=n, slots=slots, pin=pin)
            plan = asm.build_plan(requests, buf, self.device)
            check(not plan.staged, f"{what}: the plan staged its planes")
            for k in self._hold_assembly(plan, what):
                held[k] += 1
        # many waves of string tiles: one array of 4,000,000 x 16 code
        # points (64 MB, 15,625 tiles), timed in (c) too
        n = 20_000 if self.rehearsal else 4_000_000
        what = f"one string array of {n:,} x 16 code points"
        requests, buf = arrow_cases.strings(n, 16, seed=14, pin=pin)
        plan = asm.build_plan(requests, buf, self.device)
        check(not plan.staged, f"{what}: the plan staged its planes")
        for k in self._hold_assembly(plan, what):
            held[k] += 1
        self.asm14["many"] = (what, plan)
        keep = SchemaRetentionPolicy.KEEP_ORIGINAL
        # the main path's shapes: an exp1 chunk, an exp3 window's 'C'
        # batch (4,143 records of the 2,000-slot plane)
        exp1 = ColumnarDecoder(parse_copybook(g.EXP1_COPYBOOK),
                               device=self.device).decode(self.exp1_chunk)
        c_rows = 30 if self.rehearsal else 4_143
        exp3 = ColumnarDecoder(parse_copybook(g.EXP3_COPYBOOK),
                               active_segment="STATIC_DETAILS",
                               device=self.device).decode(self.exp3[:c_rows])
        self.asm14["batches"] = {"exp1 chunk": (exp1, None),
                                 "exp3 'C' batch": (exp3, "STATIC_DETAILS")}
        for what, (batch, active) in self.asm14["batches"].items():
            plan = self._batch_plan(batch, active, keep)
            check(not plan.staged, f"{what}: the plan staged its planes")
            for k in self._hold_assembly(plan, what):
                held[k] += 1
        # the reads' own assemblies: exp2's strings, the hierarchies'
        # hidden rows and positions (the planes of a joined batch staged)
        kw = {"device": "cpu"} if self.rehearsal else {}
        raw, (offsets, lengths) = self.rdw_walk["exp2"]
        k = self.n_check["exp2"]
        e2 = os.path.join(self.tmp, "p14e2.dat")
        with open(e2, "wb") as f:
            f.write(raw[:offsets[k - 1] + lengths[k - 1]])
        seven = self._write_rdw("hierarchical", 60 if self.rehearsal
                                else 600, 100)
        raw3, (o3, l3) = self.rdw_walk["exp3"]
        m = min(3000, len(o3))
        e3 = os.path.join(self.tmp, "p14e3.dat")
        with open(e3, "wb") as f:
            f.write(raw3[:o3[m - 1] + l3[m - 1]])
        reads = [("exp2 prefix", e2, dict(copybook_contents=g.EXP2_COPYBOOK,
                                          **RDW_OPTIONS)),
                 ("7-segment hierarchy", seven,
                  self._p13_seven_options(g)),
                 ("exp3 hierarchy prefix", e3,
                  dict(copybook_contents=g.EXP3_COPYBOOK, **P13_EXP3))]
        for what, path, opts in reads:
            plans = self._captured_plans(
                lambda: read_cobol(path, **opts, **kw).to_arrow())
            check(plans, f"{what}: no assembly ran")
            for i, plan in enumerate(plans):
                for kname in self._hold_assembly(plan, f"{what} {i}"):
                    held[kname] += 1
            os.remove(path)
        self.asm14["held"] = held
        if not self.rehearsal:
            for kname, count in held.items():
                check(count > 0, f"{kname} was never held to its plain "
                      f"version")
        log(f"[p14] (a) each assembly kernel == its plain version, every "
            f"byte of the output buffer and the tile bases, from the "
            f"same state: {json.dumps(held)} plans each (grid: every kind, "
            f"decimal mode, shift window, validity, hidden rows, row "
            f"tables, 2,000-slot arrays per slot and evenly spaced, "
            f"strings of uint8 and uint16 code points under each trim, "
            f"staged and direct string tiles; one string array of "
            f"{self.asm14['many'][1].str_tiles:,} tiles; the exp1 chunk, "
            f"the exp3 'C' batch, "
            f"the exp2 prefix's and the hierarchies' own assemblies); "
            f"{time.perf_counter() - t0:.1f} s")

    def _p14_bytes(self, plan, res):
        """The bytes each step must move over this run's data: each input
        read once (a hidden row's planes are not), each output written
        once. A request's planes are per-slot dicts or a `SlotPlanes`:
        both give the slot count and slot 0's planes, whose element sizes
        are every slot's."""
        np = self.np
        from cobrix_tpu_torch.ops import arrow_assemble as asm

        moved = dict.fromkeys(ARROW_KERNELS, 0)
        for i, r in enumerate(plan.requests):
            L, S = r.length, len(r.planes)
            rows = (np.repeat(np.asarray(r.rows), S) if r.rows is not None
                    else np.arange(L) // S)
            seen = (L if r.mask is None
                    else int(np.count_nonzero(np.asarray(r.mask)[rows])))
            tables = 8 * (L // S) * (r.rows is not None) + (
                L if r.mask is not None else 0)
            if r.is_string:
                cps = seen * r.width * (2 if r.src_kind == asm.SRC_CP16
                                        else 1)
                tiles = -(-L // asm.TILE)
                # lengths: the code points and tables in, a work entry a
                # tile in, the int32 lengths, a tile base a tile and the
                # request's counters out
                moved["arrow_str_lengths"] += cps + tables + 4 * (L + 1) \
                    + 16 * tiles + 32
                moved["arrow_str_copy"] += cps + tables + 8 * L + 8 * tiles \
                    + int(res.counters[i, asm.C_TOTAL])
                continue
            per = sum(p.itemsize for p in r.planes[0].values())
            moved["arrow_scalars"] += seen * per + tables + L * \
                asm.OUT_ITEMSIZE[r.out_kind] + 4 * -(-L // 32)
        return moved

    def _p14_step_times(self, plan, src, aux, res):
        """Each step's times over `plan`, from the state before it,
        restored before a call: `ms` (events around the wrapper on an
        idle stream), `device_ms` (device time alone), its plain
        version's on the card, the bound of its bytes and its share;
        beside the lengths kernel, `cumsum_device_ms`: one `torch.cumsum`
        over the same tile-sum vector, a yardstick of the scan alone."""
        torch = self.torch
        from cobrix_tpu_torch.ops import arrow_assemble as asm

        moved = self._p14_bytes(plan, res)
        times = {}
        before = asm.new_state(plan, self.device)
        for name, kernel, plain, runs, call in self._asm_steps(src, aux,
                                                               plan):
            if not runs:
                continue
            snap = tuple(t.clone() for t in before)

            def reset(snap=snap):
                for a, b in zip(before, snap):
                    a.copy_(b)
            timing = {}
            for key, fn, busy, reps in (
                    ("ms", kernel, False, 20),
                    ("device_ms", kernel, True, 20),
                    ("plain_ms", plain, False, 3)):
                timing[key] = self._time_reset(
                    lambda fn=fn: call(fn, before), reset, reps, busy)
            reset()
            call(kernel, before)
            bound = moved[name] / HBM_BYTES_PER_S * 1e3
            timing.update(bytes=moved[name], bound_ms=bound,
                          share_of_bound=bound / timing["device_ms"])
            if name == "arrow_str_lengths":
                sums = before[1][:plan.str_tiles]
                timing["cumsum_device_ms"] = self._time(
                    lambda: torch.cumsum(sums, 0), 20, busy=True)
            times[name] = timing
        return times

    def _p14_times(self):
        """(c) each step's times (`_p14_step_times`) at the exp1 chunk,
        the exp3 'C' batch and the many-wave string array; at the two
        batches the plan's host time (the median of 5 `build_plan` calls
        over the builder's requests), the copies up and back and one
        whole assembly."""
        torch = self.torch
        from cobrix_tpu_torch.copybook.datatypes import SchemaRetentionPolicy
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.reader.arrow_out import (ArrowBatchBuilder,
                                                       segment_table)

        keep = SchemaRetentionPolicy.KEEP_ORIGINAL
        self.asm14["times"] = []
        for what, (batch, active) in self.asm14["batches"].items():
            plan = self._batch_plan(batch, active, keep)
            builder = ArrowBatchBuilder(batch, active)
            builder.request_body(keep)
            plan_s = []
            for _ in range(5):
                t0 = time.perf_counter()
                asm.build_plan(builder.leaves.requests, batch.host_buffer,
                               batch.decoder.device)
                plan_s.append(time.perf_counter() - t0)
            src, aux = asm.upload(plan)
            state = asm.new_state(plan, self.device)
            used = asm.run_steps(plan, src, aux, state)
            res = asm.assemble(plan)
            rec = dict(shape=what, rows=batch.n_records,
                       requests=len(plan.requests),
                       plan_ms=statistics.median(plan_s) * 1e3,
                       string_requests=len(plan.str_ids),
                       source_bytes=int(plan.src.numel()),
                       output_bytes=used,
                       steps=self._p14_step_times(plan, src, aux, res))
            rec["device_ms"] = sum(t["device_ms"]
                                   for t in rec["steps"].values())
            rec["upload_ms"] = self._time(lambda: asm.upload(plan), 5)
            out = state[0][:used]
            host = torch.empty(used, dtype=torch.uint8,
                               pin_memory=not self.rehearsal)
            rec["download_ms"] = self._time(
                lambda: host.copy_(out, non_blocking=True), 5)
            rec["assemble_ms"] = self._time(lambda: asm.assemble(plan), 5)
            t0 = time.perf_counter()
            segment_table(batch, active, self._p14_schema(batch))
            rec["table_s"] = time.perf_counter() - t0
            self.asm14["times"].append(rec)
            log(f"[p14] {self.card}: (c) {what}: {json.dumps(rec)}")
            del src, aux, state, res
        what, plan = self.asm14.pop("many")
        src, aux = asm.upload(plan)
        rec = dict(shape=what, rows=plan.requests[0].length,
                   tiles=plan.str_tiles, source_bytes=int(plan.src.numel()),
                   steps=self._p14_step_times(plan, src, aux,
                                              asm.assemble(plan)))
        self.asm14["times"].append(rec)
        log(f"[p14] {self.card}: (c) {what}: {json.dumps(rec)}")
        del src, aux, plan

    def _p14_split(self):
        """(c) where `to_arrow` goes, on one thread: the walk of the
        schema into requests (flat tables), the plans, the assemblies on
        the card (copies up and back included) and the rest on the host
        (the arrays over the buffers, structs and lists, the record-order
        take, the concatenation)."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.reader.arrow_out import ArrowBatchBuilder
        from cobrix_tpu_torch.testing import generators as g

        kw = {"device": "cpu"} if self.rehearsal else {}
        spent = {}

        def timed(owner, name, key):
            real = getattr(owner, name)

            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    spent[key] += time.perf_counter() - t0
            setattr(owner, name, call)
            return owner, name, real
        self.asm14["split"] = {}
        for what, path, opts in (
                ("exp1", self.exp1_path,
                 dict(copybook_contents=g.EXP1_COPYBOOK,
                      debug_ignore_file_size="true")),
                ("exp3", self.rdw_files["exp3"],
                 dict(copybook_contents=g.EXP3_COPYBOOK, **RDW_OPTIONS)),
                ("exp2", self.rdw_files["exp2"],
                 dict(copybook_contents=g.EXP2_COPYBOOK, **RDW_OPTIONS)),
                ("exp3 hierarchy", self.rdw_files["exp3"],
                 dict(copybook_contents=g.EXP3_COPYBOOK, **P13_EXP3))):
            data = read_cobol(path, parallelism="1", **opts, **kw)
            spent.update(walk=0.0, plan=0.0, assemble=0.0)
            saved = [timed(ArrowBatchBuilder, "request_body", "walk"),
                     timed(asm, "build_plan", "plan"),
                     timed(asm, "assemble", "assemble")]
            try:
                t0 = time.perf_counter()
                data.to_arrow()
                total = time.perf_counter() - t0
            finally:
                for owner, name, real in saved:
                    setattr(owner, name, real)
            rec = dict(to_arrow_s=total, parts=len(data.parts), **spent,
                       rest_s=total - sum(spent.values()))
            self.asm14["split"][what] = rec
            log(f"[p14] {self.card}: (c) {what} to_arrow split, one "
                f"thread: {json.dumps(rec)}")
            del data

    def _p14_schema(self, batch):
        """An output schema for one batch's table (no generated
        columns)."""
        from cobrix_tpu_torch.reader.parameters import ReaderParameters
        from cobrix_tpu_torch.reader.schema import output_schema_for

        return output_schema_for(batch.decoder.copybook, ReaderParameters(),
                                 is_var_len=False)

    def _time_reset(self, fn, reset, reps, busy=False):
        """`_time` with `reset()` run before each call, outside the
        events (a step rewrites its state)."""
        torch = self.torch
        times = []
        for i in range(reps + 2):
            reset()
            if self.rehearsal:
                t0 = time.perf_counter()
                fn()
                dt = (time.perf_counter() - t0) * 1e3
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if busy:
                    torch.cuda._sleep(2_000_000)
                start.record()
                fn()
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end)
            if i >= 2:
                times.append(dt)
        return statistics.median(times)

    def _p14_parallelism(self):
        """(d) the exp3 hierarchy's indexed read and exp1's `to_arrow` at
        `parallelism` 1 and at its default: equal tables, times."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.testing import generators as g

        kw = {"device": "cpu"} if self.rehearsal else {}
        default = min(16, os.cpu_count() or 1)
        runs = {}
        for what, path, opts in (
                ("exp3 hierarchy", self.rdw_files["exp3"],
                 dict(copybook_contents=g.EXP3_COPYBOOK, **P13_EXP3)),
                # phase 12 left a torn 700-byte tail on the exp1 file
                ("exp1", self.exp1_path,
                 dict(copybook_contents=g.EXP1_COPYBOOK,
                      debug_ignore_file_size="true"))):
            tables = []
            for par in ("1", str(default)):
                self.sync()
                t0 = time.perf_counter()
                data = read_cobol(path, parallelism=par, **opts, **kw)
                self.sync()
                read_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                table = data.to_arrow()
                arrow_s = time.perf_counter() - t0
                runs[f"{what} parallelism {par}"] = dict(
                    read_s=read_s, to_arrow_s=arrow_s, parts=len(data.parts),
                    MBps=os.path.getsize(path) / (read_s + arrow_s) / 1e6)
                tables.append(table)
                del data
            check(tables[0].equals(tables[1]), f"{what}: the tables at "
                  f"parallelism 1 and {default} differ")
            del tables
        self.asm14["parallelism"] = runs
        log(f"[p14] {self.card}: (d) parallelism 1 against {default}: "
            f"{json.dumps(runs)}; tables equal")

    # -- phase 15: the I/O plane -------------------------------------------

    def _compress(self, src, dst, codec, limit=None):
        """`src` (its first `limit` bytes) as a multi-member `codec` feed,
        one member per 4 MiB compressed on a thread pool at the fastest
        level (``testing.corpus.member_compressor``); (seconds, wire
        bytes)."""
        from concurrent.futures import ThreadPoolExecutor

        from cobrix_tpu_torch.testing.corpus import member_compressor

        _, compress = member_compressor(codec)
        size = os.path.getsize(src) if limit is None else limit
        member = 4 << 20
        t0 = time.perf_counter()
        fd = os.open(src, os.O_RDONLY)
        try:
            def one(off):
                return compress(os.pread(fd, min(member, size - off), off))
            with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex, \
                    open(dst, "wb") as out:
                for piece in ex.map(one, range(0, size, member)):
                    out.write(piece)
        finally:
            os.close(fd)
        return time.perf_counter() - t0, os.path.getsize(dst)

    def _raw_reference(self, kind, path, cb, opts):
        """Phase 9's sequential and pipelined reads of the raw file (its
        digest and launches), or, when phase 9 did not run, the same two
        reads now."""
        ref = self.raw_reads.get(kind)
        if ref is None:
            runs = [self._pipelined_read(kind, path, cb, w, **opts)
                    for w in (0, 2)]
            check(runs[0][1] == runs[1][1], f"{kind}: the raw pipelined "
                  f"read differs from the sequential one")
            size = os.path.getsize(path)
            ref = self.raw_reads[kind] = dict(
                digest=runs[0][1], launches=runs[0][4],
                pipe_launches=runs[1][4],
                mb_per_s=[size / runs[0][0] / 1e6,
                          size / runs[1][0] / 1e6])
        return ref

    def _io_read(self, tag, feed, size, cb, workers, ref, expect,
                 keep=False, **opts):
        """One read of a compressed or backend-served input through
        read_cobol, held to the raw file's reference: the same digest
        (planes, record ids, Seg_Id columns, sampled rows) and the
        launches of every read kernel `expect` gives (the raw read's).
        Returns a summary with its io counters."""
        secs, digest, records, metrics, launches = self._pipelined_read(
            tag, feed, cb, workers, keep=keep, **opts)
        check(digest == ref["digest"], f"{tag}: planes, record ids or rows "
              f"differ from the raw file's read")
        if not self.rehearsal:
            check(launches == expect, f"{tag}: launches {launches} differ "
                  f"from the raw read's {expect}")
        self.launches[f"io_{tag}"] = launches
        io = metrics.get("io") or {}
        out = dict(secs=secs, mb_per_s=size / secs / 1e6, records=records,
                   shards=metrics["shards"], launches=launches,
                   bytes_read=metrics["bytes_read"],
                   inflate_s=io.get("inflate_s", 0.0),
                   compressed_bytes_in=io.get("compressed_bytes_in", 0),
                   decompressed_bytes_out=io.get("decompressed_bytes_out",
                                                 0),
                   inflate_skipped=io.get("inflate_skipped", 0),
                   bytes_fetched=io.get("bytes_fetched", 0),
                   index=[io.get(k, 0) for k in ("index_hits",
                                                 "index_misses",
                                                 "index_saves")])
        log(f"[io] {self.card}: {tag}: {records} records, {size} bytes "
            f"decompressed in {secs:.3f} s = {out['mb_per_s']:.1f} MB/s; "
            f"inflate_s {out['inflate_s']:.3f}, compressed in "
            f"{out['compressed_bytes_in']}, out "
            f"{out['decompressed_bytes_out']}, blocks skipped "
            f"{out['inflate_skipped']}, index hits/misses/saves "
            f"{out['index']}; launches {json.dumps(launches)}; == raw read "
            f"by hash")
        return out

    @contextlib.contextmanager
    def _index_pass_spy(self):
        """Within the block, the read kernels' launches made by the scan
        kernel's index passes (``VarLenReader._generate_index_fast``):
        the dict yielded fills with them (empty: no index pass ran)."""
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import fused_decode
        from cobrix_tpu_torch.reader import var_len_reader as vlr

        counters = {"fused_decode": fused_decode, "rdw_scan": df.scan_window,
                    "pack_records": df.pack_records}
        spent = {}
        real = vlr.VarLenReader._generate_index_fast

        def counted(reader, *a, **k):
            before = {n: fn.launches for n, fn in counters.items()}
            try:
                return real(reader, *a, **k)
            finally:
                for n, fn in counters.items():
                    spent[n] = spent.get(n, 0) + fn.launches - before[n]
        vlr.VarLenReader._generate_index_fast = counted
        try:
            yield spent
        finally:
            vlr.VarLenReader._generate_index_fast = real

    def phase_io(self):
        """Phase 15: (a) compressed feeds, (b) a registered backend with
        retries, read-ahead, the block cache and the persisted index,
        (c) a damaged feed under the permissive policy."""
        t_phase = time.perf_counter()
        self.p15 = {}
        self._p15_feeds()
        self._p15_backend()
        self._p15_damage()
        self.p15["secs"] = time.perf_counter() - t_phase
        log(f"[io] phase 15: {self.p15['secs']:.1f} s; "
            f"{json.dumps(self.p15, default=str)}")

    def _p15_feeds(self):
        from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,
                                                         EXP2_COPYBOOK,
                                                         EXP3_COPYBOOK)

        block = (256 << 10) if self.rehearsal else (4 << 20)
        block_mb = str(block / (1 << 20))
        files = [("exp1", self.exp1_path, EXP1_COPYBOOK, {}, "gzip",
                  self.e2e[0]),
                 ("exp3", self.rdw_files["exp3"], EXP3_COPYBOOK,
                  RDW_OPTIONS, "gzip", None),
                 ("exp2", self.rdw_files["exp2"], EXP2_COPYBOOK,
                  RDW_OPTIONS, "xz", None)]
        self.p15_gz = {}
        for kind, path, cb, opts, codec, limit in files:
            # phase 12 left a torn tail on the exp1 file: its feed is the
            # phase 3 bytes
            size = limit or os.path.getsize(path)
            ext = {"gzip": "gz", "xz": "xz"}[codec]
            feed = os.path.join(self.tmp, f"{kind}.dat.{ext}")
            secs, wire = self._compress(path, feed, codec, limit)
            log(f"[io] wrote {kind} as {codec} ({wire} wire bytes for "
                f"{size}: ratio {size / wire:.2f}) in {secs:.1f} s")
            ref = self._raw_reference(kind, path, cb, opts)
            runs = {"wire_bytes": wire, "ratio": size / wire,
                    "raw_mb_per_s": ref["mb_per_s"]}
            seq = self._io_read(f"{kind}_{codec}_sequential", feed, size, cb,
                                0, ref, ref["launches"],
                                keep=kind == "exp3", **opts)
            check(seq["bytes_read"] == size,
                  f"{kind}: bytes_read {seq['bytes_read']} is not the "
                  f"decompressed size {size}")
            runs["sequential"] = seq
            if kind == "exp3":
                self._p15_arrow(cb, opts)
            if kind != "exp2":
                # a budget that holds the whole decompressed plane (the
                # default 1,024 MB would evict exp1's blocks)
                cache = os.path.join(self.tmp, f"cache_{kind}")
                copts = dict(opts, cache_dir=cache, cache_max_mb="4096",
                             compress_block_mb=block_mb)
                blocks = -(-size // block)
                # the warm read loads the sparse index from the cache: it
                # launches what the cold one did less the index pass
                expect = ref["pipe_launches"]
                for state in ("cold", "warm"):
                    with self._index_pass_spy() as spy:
                        run = self._io_read(
                            f"{kind}_{codec}_pipelined_{state}", feed, size,
                            cb, 2, ref, expect, **copts)
                    runs[f"pipelined_{state}"] = run
                    if state == "cold":
                        expect = {k: v - spy.get(k, 0)
                                  for k, v in expect.items()
                                  if v > spy.get(k, 0)
                                  or k == "fused_decode"}
                    else:
                        check(not spy, f"{kind}: the warm pipelined read "
                              f"made an index pass: {spy}")
                warm = runs["pipelined_warm"]
                check(warm["compressed_bytes_in"] == 0
                      and warm["decompressed_bytes_out"] == 0,
                      f"{kind}: the warm pipelined read inflated")
                check(warm["inflate_skipped"] >= blocks,
                      f"{kind}: the warm pipelined read served "
                      f"{warm['inflate_skipped']} cached blocks for "
                      f"{blocks}")
                one = self._io_read(f"{kind}_{codec}_sequential_warm", feed,
                                    size, cb, 0, ref, ref["launches"],
                                    **copts)
                check(one["compressed_bytes_in"] == 0
                      and one["inflate_skipped"] == blocks,
                      f"{kind}: the warm sequential read skipped "
                      f"{one['inflate_skipped']} of {blocks} blocks, "
                      f"compressed bytes in {one['compressed_bytes_in']}")
                runs["sequential_warm"] = one
            self.p15[kind] = runs
            log(f"[io] {self.card}: {kind} {codec}: decompressed MB/s "
                + ", ".join(f"{k} {v['mb_per_s']:.1f}" for k, v in
                            runs.items() if isinstance(v, dict))
                + f"; the raw file's (phase 9, workers 0 / 2): "
                + " / ".join(f"{m:.1f}" for m in ref["mb_per_s"]))
            if kind == "exp2":
                gz = os.path.join(self.tmp, "exp2.dat.gz")
                self._compress(path, gz, "gzip")
                self.p15_gz["exp2"] = gz

    def _p15_arrow(self, cb, opts):
        """`to_arrow` of the sequential gzip exp3 read (kept by
        `_io_read`) against phase 11's table of the raw file (or the
        same read of it now)."""
        from cobrix_tpu_torch.ops import arrow_assemble as asm

        data, self.kept = self.kept, None
        for fn in asm.KERNELS.values():
            fn.launches = 0
        table = data.to_arrow()
        self.launches["io_exp3_gzip_arrow"] = {}
        self._count_arrow("io_exp3_gzip_arrow")
        want = getattr(self, "p11_exp3_table", None)
        if want is None:
            raw, _ = self._counted_read("io_exp3_raw_arrow",
                                        self.rdw_files["exp3"],
                                        copybook_contents=cb, **opts)
            want = raw.to_arrow()
            self._count_arrow("io_exp3_raw_arrow")
            del raw
        check(table.equals(want, check_metadata=True),
              "the gzip exp3 read's table differs from phase 11's")
        log("[io] the gzip exp3 read's to_arrow() == phase 11's table")
        self.p11_exp3_table = None
        del data, table, want

    def _p15_backend(self):
        """(b) the exp2 file served by a registered ByteRangeSource, plain
        and through ChaosSource (every 7th read fails) with retries,
        read-ahead, the block cache and the persisted index, then warm."""
        from cobrix_tpu_torch import register_stream_backend
        from cobrix_tpu_torch.reader.stream import _LocalFileSource
        from cobrix_tpu_torch.testing.faults import ChaosSource
        from cobrix_tpu_torch.testing.generators import EXP2_COPYBOOK

        path = self.rdw_files["exp2"]
        size = os.path.getsize(path)
        ref = self._raw_reference("exp2", path, EXP2_COPYBOOK, RDW_OPTIONS)
        chaos = []

        def chaotic(url):
            source = ChaosSource(_LocalFileSource(path), fail_every=7)
            chaos.append(source)
            return source
        register_stream_backend("smokeplain",
                                lambda url: _LocalFileSource(path))
        register_stream_backend("smokechaos", chaotic)
        runs = {"plain": self._io_read("exp2_backend", "smokeplain://exp2",
                                       size, EXP2_COPYBOOK, 0, ref,
                                       ref["launches"], **RDW_OPTIONS)}
        # the rehearsal's small file: small blocks (several fetches a
        # source) and an explicit split (the full file is over the
        # default 100 MB one, so its read is indexed)
        opts = dict(RDW_OPTIONS, io_retry_attempts="6",
                    io_retry_base_delay_ms="1", prefetch_blocks="4",
                    cache_max_mb="4096",
                    io_block_mb="0.01" if self.rehearsal else "8",
                    cache_dir=os.path.join(self.tmp, "cache_backend"))
        if self.rehearsal:
            opts["input_split_records"] = "500"

        for state in ("cold", "warm"):
            before = len(chaos)
            runs[state] = self._io_read(
                f"exp2_chaos_{state}", "smokechaos://exp2", size,
                EXP2_COPYBOOK, 0, ref, ref["launches"], **opts)
            if state == "cold":
                served = sum(s.failures_served for s in chaos[before:])
                diag = self.last_diagnostics
                retries = diag.io_retries if diag is not None else 0
        cold, warm = runs["cold"], runs["warm"]
        check(cold["bytes_fetched"] >= size, "the cold backend read "
              f"fetched {cold['bytes_fetched']} of {size} bytes")
        check(served >= 1 and retries >= served,
              f"{served} injected failures, {retries} retries ledgered")
        check(warm["bytes_fetched"] == 0, f"the warm read fetched "
              f"{warm['bytes_fetched']} backend bytes")
        check(warm["index"][0] >= 1 and warm["index"][1] == 0,
              f"the warm read made an index pass: {warm['index']}")
        runs["failures_served"] = served
        runs["ledgered_retries"] = retries
        self.p15["backend"] = runs
        log(f"[io] {self.card}: exp2 through a registered backend: plain "
            f"{runs['plain']['mb_per_s']:.1f} MB/s, chaos cold "
            f"{cold['mb_per_s']:.1f}, warm {warm['mb_per_s']:.1f} MB/s; "
            f"{served} injected failures, {retries} retries ledgered; warm "
            f"fetched 0 backend bytes, index hits {warm['index'][0]}")

    def _p15_damage(self):
        """(c) the gzip exp2 feed with its last member torn, read under
        the permissive policy on the card and on the CPU: equal row
        counts and ledgers."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.testing.faults import truncate_compressed_member
        from cobrix_tpu_torch.testing.generators import EXP2_COPYBOOK

        with open(self.p15_gz["exp2"], "rb") as f:
            torn, cut = truncate_compressed_member(f.read())
        path = os.path.join(self.tmp, "exp2_torn.dat.gz")
        with open(path, "wb") as f:
            f.write(torn)
        del torn
        opts = dict(RDW_OPTIONS, copybook_contents=EXP2_COPYBOOK,
                    record_error_policy="permissive")
        card, secs = self._counted_read("io_exp2_torn", path, **opts)
        # the CPU read decodes one field: the ledger is the framing's
        t0 = time.perf_counter()
        cpu = read_cobol(path, device="cpu", select="SEGMENT-ID", **opts)
        cpu_s = time.perf_counter() - t0
        got, want = card.diagnostics.as_dict(), cpu.diagnostics.as_dict()
        check(got == want, f"the torn feed's ledger differs from the CPU "
              f"read's: {got} vs {want}")
        check(len(card) == len(cpu) and got["corrupt_records"] >= 1,
              f"torn feed: {len(card)} rows vs {len(cpu)} on the CPU, "
              f"ledger {got}")
        check((card.metrics.as_dict().get("io") or {}).get(
            "compress_corrupt", 0) >= 1, "the damage was not counted")
        self.p15["damage"] = dict(cut=cut, rows=len(card), secs=secs,
                                  cpu_secs=cpu_s, ledger=got)
        log(f"[io] {self.card}: exp2 gzip torn at wire byte {cut}: "
            f"{len(card)} rows in {secs:.3f} s (CPU {cpu_s:.1f} s), ledger "
            f"== the CPU read's: {json.dumps(got)}")
        del card, cpu

    # -- phase 16: filter pushdown ---------------------------------------

    def _p16_counters(self):
        """{kernel name: wrapper} for every kernel of the kernels line,
        and {name: plain version} of the two the stages launch (their
        counters count the wrapper's plain route, in the rehearsal)."""
        from cobrix_tpu_torch.ops import aggregate as agg_mod
        from cobrix_tpu_torch.ops import arrow_assemble as asm
        from cobrix_tpu_torch.ops import device_framing as df
        from cobrix_tpu_torch.ops.fused_decode import (fused_decode,
                                                       fused_decode_plain)

        kernels = {"fused_decode": fused_decode, "rdw_scan": df.scan_window,
                   "pack_records": df.pack_records,
                   "aggregate": agg_mod.aggregate, **asm.KERNELS}
        plain = {"fused_decode": fused_decode_plain,
                 "pack_records": df.pack_records_plain}
        return kernels, plain

    def _p16_count(self, fn):
        """Run `fn()` with every kernel's launches counted from 0: its
        result and {kernel: launches} (the plain versions' counts in the
        rehearsal, where no kernel launches); the launches join the
        pushdown path unless `fn` is a reference read."""
        kernels, plain = self._p16_counters()
        for f in list(kernels.values()) + list(plain.values()):
            f.launches = 0
        self.sync()
        out = fn()
        self.sync()
        got = {k: f.launches for k, f in kernels.items()}
        if self.rehearsal:
            got.update({k: f.launches for k, f in plain.items()})
        return out, got

    def _p16_read(self, tag, path, arrow=True, **opts):
        """A filtered read_cobol on the default device and its table:
        (data, table, read seconds, launches); the launches (read and
        `to_arrow`) join the pushdown path."""
        from cobrix_tpu_torch import read_cobol

        kw = {"device": "cpu"} if self.rehearsal else {}
        timing = {}

        def run():
            t0 = time.perf_counter()
            data = read_cobol(path, **opts, **kw)
            self.sync()
            timing["read"] = time.perf_counter() - t0
            return data, (data.to_arrow() if arrow else None)
        (data, table), launches = self._p16_count(run)
        for k, v in launches.items():
            self.p16_launches[k] += v
        self.p16["launches"][tag] = {k: v for k, v in launches.items() if v}
        return data, table, timing["read"], launches

    def _p16_reference(self, path, arrow=True, **opts):
        """A read on the default device that the filtered reads are held
        to (not on the pushdown path), its table, and its read seconds."""
        from cobrix_tpu_torch import read_cobol

        kw = {"device": "cpu"} if self.rehearsal else {}
        self.sync()
        t0 = time.perf_counter()
        data = read_cobol(path, **opts, **kw)
        self.sync()
        secs = time.perf_counter() - t0
        return data, (data.to_arrow() if arrow else None), secs

    @staticmethod
    def _p16_leaf(table, name):
        """The flattened column of leaf `name` (null where a parent struct
        is null), pyarrow's own walk of the table."""
        import pyarrow as pa

        while any(pa.types.is_struct(f.type) for f in table.schema):
            table = table.flatten()
        hits = [c for c in table.column_names
                if c == name or c.endswith("." + name)]
        check(len(hits) == 1, f"leaf {name}: columns {hits}")
        return table.column(hits[0])

    def _p16_expected(self, full, mask):
        return full.filter(self.pc.fill_null(mask, False))

    def _p16_check(self, what, data, table, expect, launches, stage1,
                   scanned, n_units, residual=False):
        """A filtered read's table equals the reference filtered with
        pyarrow, its counters agree with it, and its kernels launched as
        the stages say: on a fixed-length read of `n_units` chunks each
        chunk launches the fused decode and the pack once for stage 1
        (`stage1`) and once more for stage 2 when it keeps any record."""
        self._same_table(table.replace_schema_metadata(None),
                         expect.replace_schema_metadata(None), what)
        pd = data.metrics.pushdown
        kept = expect.num_rows
        check(pd is not None and pd["records_scanned"] == scanned
              and pd["records_pruned"] == scanned - kept,
              f"{what}: counters {pd}, {kept} of {scanned} kept")
        check(bool(pd["records_pruned_residual"]) == (residual
                                                      and kept < scanned),
              f"{what}: residual pruning {pd}")
        if n_units is not None:
            keeping = sum(1 for p in data.parts if p.n_rows)
            want = stage1 * n_units + keeping
            for k in ("fused_decode", "pack_records"):
                check(launches[k] == want,
                      f"{what}: {k} launched {launches[k]} times for "
                      f"{n_units} chunks, {keeping} of them keeping "
                      f"records")
        return pd

    def phase_pushdown(self):
        """Phase 16: filter pushdown on the card (see the module
        docstring): (a) exp1, (b) exp3 and exp2 RDW, (c) the exp3
        hierarchy's residual filter, (d) the dataset scan surface."""
        import pyarrow.compute as pc

        self.pc = pc
        t_phase = time.perf_counter()
        self.p16 = {"launches": {}}
        self.p16_launches = dict.fromkeys(KERNELS, 0)
        self._p16_exp1()
        self._p16_rdw()
        self._p16_hierarchy()
        self._p16_dataset()
        self._p16_split()
        self.launches["pushdown"] = dict(self.p16_launches)
        if not self.rehearsal:
            for k in ("fused_decode", "rdw_scan", "pack_records",
                      "arrow_scalars", "arrow_str_lengths",
                      "arrow_str_copy"):
                check(self.p16_launches[k] > 0,
                      f"{k} never launched on the pushdown path")
        self.p16["secs"] = time.perf_counter() - t_phase
        log(f"[pushdown] {self.card}: phase 16 {self.p16['secs']:.1f} s; "
            f"launches on the pushdown path "
            f"{json.dumps(self.p16_launches)}")

    # the exp1 filters of phase 16: one COMP-3 field and one string isin
    # (kept share 5-20%), one that keeps every record (nulls included),
    # one that keeps none
    P16_NAMES = ("Carrie", "Janiece", "Estelle", "Sunday", "Inge",
                 "Gabriele")

    def _p16_exp1_filters(self, full):
        import pyarrow as pa

        pc = self.pc
        num = self._p16_leaf(full, "NUM_BCD_INT05")
        name = self._p16_leaf(full, "STRING_VAL")
        rid = self._p16_leaf(full, "ID")
        names = ", ".join(f"'{n}'" for n in self.P16_NAMES)
        return {
            "mixed": (f"NUM_BCD_INT05 < 50000 and STRING_VAL in ({names})",
                      pc.and_kleene(pc.less(num, 50000), pc.is_in(
                          name, value_set=pa.array(self.P16_NAMES)))),
            "all": ("ID >= 0 or ID == null",
                    pc.or_kleene(pc.greater_equal(rid, 0),
                                 pc.is_null(rid))),
            "none": ("ID < 0", pc.less(rid, 0)),
        }

    def _p16_exp1(self):
        """(a) the phase 3 exp1 file, sequential and pipelined, under the
        three filters: each table equals the unfiltered card read's
        filtered with pyarrow, its first rows a CPU read's of the first
        records' bytes; counters, launches, MB/s beside the unfiltered
        read's."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        rs = 1493
        path, size = self.exp1_path, self.e2e[0]
        if os.path.getsize(path) != size:
            # phase 12 (c) left a torn tail on it: the phase 3 bytes
            os.truncate(path, size)
        n = size // rs
        cb = dict(copybook_contents=EXP1_COPYBOOK)
        modes = {"sequential": {},
                 "pipelined": {"pipeline_workers": "2",
                               "chunk_size_mb": self.pipe_chunk_mb}}
        full_data, full, full_s = self._p16_reference(path, **cb)
        del full_data
        base = {"sequential": full_s}
        base["pipelined"] = self._p16_reference(
            path, arrow=False, **cb, **modes["pipelined"])[2]
        filters = self._p16_exp1_filters(full)
        n_prefix = 400 if self.rehearsal else 5_000
        prefix = os.path.join(self.tmp, "exp1_prefix.dat")
        with open(path, "rb") as f, open(prefix, "wb") as g:
            g.write(f.read(n_prefix * rs))
        out = {}
        for fname, (flt, mask) in filters.items():
            expect = self._p16_expected(full, mask)
            share = expect.num_rows / n
            if fname == "mixed":
                check(0.05 <= share <= 0.20,
                      f"exp1 mixed filter keeps {share:.3f} of the records")
            cpu = read_cobol(prefix, device="cpu", filter=flt,
                             **cb).to_arrow()
            for mode, extra in modes.items():
                tag = f"exp1_{fname}_{mode}"
                data, table, secs, launches = self._p16_read(
                    tag, path, filter=flt, **cb, **extra)
                chunks = data.metrics.shards
                pd = self._p16_check(
                    f"exp1 {fname} {mode}", data, table, expect, launches,
                    1, n, chunks)
                self._same_table(table.slice(0, cpu.num_rows), cpu,
                                 f"exp1 {fname} {mode}: the first "
                                 f"{n_prefix} records' rows vs the CPU")
                out[tag] = dict(
                    kept=expect.num_rows, share=round(share, 6),
                    chunks=chunks, secs=secs, mb_per_s=size / secs / 1e6,
                    unfiltered_mb_per_s=size / base[mode] / 1e6,
                    fused=launches["fused_decode"],
                    pack=launches["pack_records"], counters=pd)
                log(f"[pushdown] {self.card}: exp1 {fname} {mode}: "
                    f"{expect.num_rows} of {n} kept ({share:.4f}); "
                    f"{size / secs / 1e6:.1f} MB/s filtered vs "
                    f"{size / base[mode] / 1e6:.1f} unfiltered; fused "
                    f"{launches['fused_decode']} / pack "
                    f"{launches['pack_records']} launches for {chunks} "
                    f"chunks; counters {json.dumps(pd)}")
                del data, table
            del expect
        self.p16["exp1"] = out
        self.p16_exp1_full = full
        self.p16_exp1_filters = filters
        os.remove(prefix)

    def _p16_rdw(self):
        """(b) exp3 with a segment conjunct and a value predicate,
        sequential and pipelined, against the unfiltered card read
        filtered with pyarrow and a CPU read of its first records; exp2
        with a segment conjunct alone: no stage-1 launch (the launches and
        table of the segment_filter option's read)."""
        pc = self.pc
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.testing.generators import (EXP2_COPYBOOK,
                                                         EXP3_COPYBOOK)

        path = self.rdw_files["exp3"]
        size = os.path.getsize(path)
        opts = dict(RDW_OPTIONS, copybook_contents=EXP3_COPYBOOK)
        flt = ("segment('C') and TAXPAYER_TYPE == 'N' and "
               "TAXPAYER_NUM < 50000000 and COMPANY_NAME >= 'E'")
        _, full, full_s = self._p16_reference(path, **opts)
        leaf = lambda name: self._p16_leaf(full, name)  # noqa: E731
        mask = pc.and_kleene(
            pc.and_kleene(pc.equal(leaf("SEGMENT_ID"), "C"),
                          pc.equal(leaf("TAXPAYER_TYPE"), "N")),
            pc.and_kleene(pc.less(leaf("TAXPAYER_NUM"), 50000000),
                          pc.greater_equal(leaf("COMPANY_NAME"), "E")))
        expect = self._p16_expected(full, mask)
        n = full.num_rows
        del full
        # the first records' bytes, cut before the header of the last
        # record the head holds (which may be cut), read on the CPU
        with open(path, "rb") as f:
            head = f.read((1 << 20) if self.rehearsal else (16 << 20))
        offs, _ = host_walk(head)
        n_prefix = len(offs) - 1
        prefix = os.path.join(self.tmp, "exp3_prefix.dat")
        with open(prefix, "wb") as g:
            g.write(head[:offs[-1] - 4])
        cpu = read_cobol(prefix, device="cpu", filter=flt,
                         **opts).to_arrow()
        os.remove(prefix)
        out = {}
        for mode, extra in (("sequential", {}),
                            ("pipelined", {"pipeline_workers": "2",
                                           "chunk_size_mb":
                                           self.pipe_chunk_mb})):
            tag = f"exp3_{mode}"
            data, table, secs, launches = self._p16_read(
                tag, path, filter=flt, **opts, **extra)
            pd = self._p16_check(f"exp3 {mode}", data, table, expect,
                                 launches, 1, n, None)
            check(pd["records_pruned_segment"] > 0
                  and pd["records_pruned_filter"] > 0,
                  f"exp3 {mode}: counters {pd}")
            got = table.filter(pc.less(table.column("Record_Id"),
                                       n_prefix))
            self._same_table(got, cpu, f"exp3 {mode}: the first "
                             f"{n_prefix} records' rows vs the CPU")
            out[tag] = dict(kept=expect.num_rows, secs=secs,
                            mb_per_s=size / secs / 1e6,
                            unfiltered_mb_per_s=(size / full_s / 1e6
                                                 if mode == "sequential"
                                                 else None),
                            launches=launches, counters=pd)
            log(f"[pushdown] {self.card}: exp3 {mode}: {expect.num_rows} "
                f"of {n} kept; {size / secs / 1e6:.1f} MB/s (unfiltered "
                f"sequential {size / full_s / 1e6:.1f}); launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}; "
                f"counters {json.dumps(pd)}")
            del data, table
        # exp2: a segment conjunct alone decodes no filter column
        path = self.rdw_files["exp2"]
        size = os.path.getsize(path)
        opts = dict(RDW_OPTIONS, copybook_contents=EXP2_COPYBOOK)
        data, table, secs, launches = self._p16_read(
            "exp2_segment_only", path, filter="segment('C')", **opts)
        (ref, ref_table), ref_launches = self._p16_count(
            lambda: self._p16_reference(path, segment_filter="C",
                                        **opts)[:2])
        self._same_table(table, ref_table, "exp2 segment('C') vs the "
                         "segment_filter option's read")
        for k in ("fused_decode", "pack_records", "rdw_scan"):
            check(launches[k] == ref_launches[k],
                  f"exp2 segment('C'): {k} {launches[k]} vs "
                  f"{ref_launches[k]} without a stage 1")
        pd = data.metrics.pushdown
        check(pd["records_pruned_segment"] > 0
              and pd["records_pruned_filter"] == 0,
              f"exp2 segment('C'): counters {pd}")
        out["exp2_segment_only"] = dict(kept=len(data), secs=secs,
                                        mb_per_s=size / secs / 1e6,
                                        launches=launches, counters=pd)
        log(f"[pushdown] {self.card}: exp2 segment('C'): {len(data)} kept "
            f"in {secs:.3f} s = {size / secs / 1e6:.1f} MB/s; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})} == "
            f"the segment_filter read's; counters {json.dumps(pd)}")
        del data, table, ref, ref_table
        self.p16["rdw"] = out

    def _p16_hierarchy(self):
        """(c) the exp3 hierarchy with a value filter: the residual route
        (the assembled table filtered), equal to the unfiltered
        hierarchical read filtered with pyarrow."""
        pc = self.pc
        from cobrix_tpu_torch.testing.generators import EXP3_COPYBOOK

        path = self.rdw_files["exp3"]
        size = os.path.getsize(path)
        opts = dict(P13_EXP3, copybook_contents=EXP3_COPYBOOK)
        _, full, full_s = self._p16_reference(path, **opts)
        expect = self._p16_expected(full, pc.greater_equal(
            self._p16_leaf(full, "COMPANY_NAME"), "M"))
        n = full.num_rows
        del full
        data, table, secs, launches = self._p16_read(
            "exp3_hierarchy", path, filter="COMPANY_NAME >= 'M'", **opts)
        pd = self._p16_check("exp3 hierarchy", data, table, expect,
                             launches, 0, n, None, residual=True)
        self.p16["hierarchy"] = dict(
            roots=n, kept=expect.num_rows, secs=secs,
            mb_per_s=size / secs / 1e6,
            unfiltered_mb_per_s=size / full_s / 1e6, launches=launches,
            counters=pd)
        log(f"[pushdown] {self.card}: exp3 hierarchy COMPANY_NAME >= 'M': "
            f"{expect.num_rows} of {n} roots kept on the residual route; "
            f"{size / secs / 1e6:.1f} MB/s (unfiltered "
            f"{size / full_s / 1e6:.1f}); counters {json.dumps(pd)}")
        del data, table, expect

    def _p16_dataset(self):
        """(d) query.dataset on exp1: count_rows and aggregate with the
        mixed filter (a pyarrow expression) against pyarrow over the
        unfiltered table of (a)."""
        import pyarrow.compute as pc
        from cobrix_tpu_torch.query import dataset
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        full = self.p16_exp1_full
        _, mask = self.p16_exp1_filters["mixed"]
        kw = {"device": "cpu"} if self.rehearsal else {}
        ds = dataset(self.exp1_path, copybook_contents=EXP1_COPYBOOK,
                     schema_retention_policy="collapse_root", **kw)
        expr = (pc.field("NUM_BCD_INT05") < 50000) & pc.field(
            "STRING_VAL").isin(list(self.P16_NAMES))
        aggs = ["count", "sum:NUM_BCD_INT05", "min:NUM_BCD_INT05",
                "max:NUM_BCD_INT05", "max:STRING_VAL"]

        def run():
            t0 = time.perf_counter()
            count = ds.count_rows(filter=expr)
            t1 = time.perf_counter()
            got = ds.aggregate(aggs, filter=expr)
            return count, got, t1 - t0, time.perf_counter() - t1
        (count, got, count_s, agg_s), launches = self._p16_count(run)
        for k, v in launches.items():
            self.p16_launches[k] += v
        self.p16["launches"]["dataset"] = {k: v for k, v in launches.items()
                                           if v}
        kept = full.filter(pc.fill_null(mask, False))
        num = self._p16_leaf(kept, "NUM_BCD_INT05")
        mm = pc.min_max(num).as_py()
        want = {"count": kept.num_rows,
                "sum:NUM_BCD_INT05": pc.sum(num).as_py(),
                "min:NUM_BCD_INT05": mm["min"],
                "max:NUM_BCD_INT05": mm["max"],
                "max:STRING_VAL": pc.max(self._p16_leaf(
                    kept, "STRING_VAL")).as_py()}
        check(count == kept.num_rows, f"dataset count_rows {count} vs "
              f"{kept.num_rows}")
        check(got == want, f"dataset aggregate {got} vs pyarrow {want}")
        check(ds.count_rows() == full.num_rows, "dataset count_rows()")
        self.p16["dataset"] = dict(count=count, aggregate=got,
                                   count_s=count_s, aggregate_s=agg_s,
                                   launches=launches)
        log(f"[pushdown] {self.card}: dataset count_rows {count} in "
            f"{count_s:.3f} s, aggregate {json.dumps(got)} in {agg_s:.3f} s "
            f"== pyarrow over the unfiltered table; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        del self.p16_exp1_full, full, kept

    def _p16_split(self):
        """(e) where one exp1 chunk's filtered read goes, on a reader of
        its own (its launches are not the pushdown path's): the chunk's
        H2D, stage 1's decode (pack and fused decode at the filter plan's
        extent, one copy back), the filter columns' Arrow arrays (the
        assembly kernels), the predicate (pyarrow, host), stage 2's
        decode of the kept records, and `read_image` whole; beside them
        the unfiltered decode of the same chunk (its H2D included).
        Medians of 5, host clock around synchronized work, ms."""
        np, torch = self.np, self.torch
        import cobrix_tpu_torch.api as api
        from cobrix_tpu_torch.reader.fixed_len_reader import FixedLenReader
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        flt, _ = self.p16_exp1_filters["mixed"]
        reader = FixedLenReader(EXP1_COPYBOOK,
                                api.parse_options({"filter": flt}),
                                device=self.device)
        pd = reader.pushdown
        rs = reader.record_size
        n = api.FIXED_READ_CHUNK_BYTES // rs
        buf = np.fromfile(self.exp1_path, dtype=np.uint8, count=n * rs)
        offsets = np.arange(n, dtype=np.int64) * rs
        lengths = np.full(n, rs, dtype=np.int64)
        stage1 = pd._stage1_decoder(reader._decoders, self.device, "")
        state = {}

        def h2d():
            state["image"] = torch.from_numpy(buf).to(self.device)

        def decode1():
            state["batch"] = stage1.decode_raw(state["image"], offsets,
                                               lengths)

        def arrays():
            state["arrays"] = pd._arrays_from_batch(state["batch"], None,
                                                    None)

        def predicate():
            state["kept"] = np.nonzero(pd._mask(pd.value_expr,
                                                state["arrays"], n))[0]

        def decode2():
            kept = state["kept"]
            reader.decoder().decode_raw(state["image"], offsets[kept],
                                        lengths[kept])

        def whole():
            reader.read_image(state["image"], lengths)

        def unfiltered():
            reader.decoder().decode(buf.reshape(n, rs))
        steps = [("h2d", h2d), ("stage1_decode", decode1),
                 ("stage1_arrow", arrays), ("predicate", predicate),
                 ("stage2_decode", decode2), ("read_image", whole),
                 ("unfiltered_decode", unfiltered)]
        times = {}
        for name, fn in steps:
            laps = []
            for _ in range(5):
                self.sync()
                t0 = time.perf_counter()
                fn()
                self.sync()
                laps.append((time.perf_counter() - t0) * 1e3)
            times[name] = statistics.median(laps)
        self.p16["chunk_split_ms"] = dict(rows=n, kept=len(state["kept"]),
                                          **times)
        log(f"[pushdown] {self.card}: one exp1 chunk ({n} records, "
            f"{len(state['kept'])} kept), ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))

    # -- phase 17: the observability plane ---------------------------------

    def phase_obs(self):
        """Phase 17: the observability plane on the card (see the module
        docstring): (c) explain before any read, (d) a read with
        attribution off (the references), (a) exp1 traced, attributed
        and explained, sequential and pipelined, (b) exp3 RDW traced and
        attributed."""
        t_phase = time.perf_counter()
        self.p17 = {"launches": {}}
        self.p17_launches = dict.fromkeys(KERNELS, 0)
        path, size = self.exp1_path, self.e2e[0]
        if os.path.getsize(path) != size:
            # phase 12 (c) left a torn tail on it: the phase 3 bytes
            os.truncate(path, size)
        self._p17_explain(path)
        ref = self._p17_plain(path, size)
        for mode in ("sequential", "pipelined"):
            self._p17_exp1(path, size, mode, ref)
        del ref
        self._p17_rdw()
        self.launches["obs"] = dict(self.p17_launches)
        if not self.rehearsal:
            for k in READ_KERNELS + ARROW_KERNELS:
                check(self.p17_launches[k] > 0,
                      f"{k} never launched on the observability path")
        self.p17["secs"] = time.perf_counter() - t_phase
        log(f"[obs] {self.card}: phase 17 {self.p17['secs']:.1f} s; "
            f"launches on the observability path "
            f"{json.dumps(self.p17_launches)}")

    def _p17_count(self, tag, fn):
        """`fn()` with every kernel's launches counted from 0 (the plain
        versions' in the rehearsal): (result, launches). The launches
        join the observability path under `tag`."""
        out, launches = self._p16_count(fn)
        for k, v in launches.items():
            if k in self.p17_launches:
                self.p17_launches[k] += v
        self.p17["launches"][tag] = {k: v for k, v in launches.items() if v}
        return out, launches

    @contextlib.contextmanager
    def _p17_syncs(self):
        """Counts the CUDA synchronizes made inside the block (stream,
        event and device ones), by wrapping them in this script only:
        yields a one-element list. Nothing is counted in the
        rehearsal."""
        torch = self.torch
        syncs = [0]
        patched = []
        if not self.rehearsal:
            for owner, name in ((torch.cuda.Stream, "synchronize"),
                                (torch.cuda.Event, "synchronize"),
                                (torch.cuda, "synchronize")):
                real = getattr(owner, name)

                def counted(*a, _real=real, **k):
                    syncs[0] += 1
                    return _real(*a, **k)
                patched.append((owner, name, real))
                setattr(owner, name, counted)
        try:
            yield syncs
        finally:
            for owner, name, real in patched:
                setattr(owner, name, real)

    def _p17_explain(self, path):
        """(c) explain over the exp1 file before any read of this phase:
        it renders, its dict survives JSON, it launches nothing."""
        from cobrix_tpu_torch import explain
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        kw = {"device": "cpu"} if self.rehearsal else {}
        t0 = time.perf_counter()
        with self._p17_syncs() as syncs:
            rep, launches = self._p17_count(
                "explain", lambda: explain(copybook_contents=EXP1_COPYBOOK,
                                           path=path, **kw))
        secs = time.perf_counter() - t0
        text = rep.render()
        doc = rep.as_dict()
        check(json.loads(json.dumps(doc)) == doc,
              "explain: as_dict does not survive JSON")
        check(doc["plan"]["total_bytes"] == os.path.getsize(path)
              and doc["copybook"]["record_size"] == 1493,
              f"explain: plan {doc['plan']}")
        check(not any(launches.values()),
              f"explain launched kernels: {launches}")
        check("copybook:" in text and "cache planes:" in text,
              "explain: render")
        self.p17["explain"] = dict(secs=secs, plan=doc["plan"],
                                   cache_planes=doc["cache_planes"])
        log(f"[obs] explain in {secs:.3f} s, no launch; plan "
            f"{json.dumps(doc['plan'])}")

    def _p17_plain(self, path, size):
        """(d) the exp1 read with attribution off, sequential: no
        field-cost timer call; its synchronizes, launches, planes digest
        and table are the references of (a)."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.obs import fieldcost
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        kw = {"device": "cpu"} if self.rehearsal else {}
        timers = fieldcost.timer_calls()
        timing = {}

        def run():
            t0 = time.perf_counter()
            with self._p17_syncs() as syncs:
                data = read_cobol(path, copybook_contents=EXP1_COPYBOOK,
                                  **kw)
            self.sync()
            timing["read"] = time.perf_counter() - t0
            timing["syncs"] = syncs[0]
            return data
        data, launches = self._p17_count("exp1_plain", run)
        syncs = timing["syncs"]
        check(fieldcost.timer_calls() == timers,
              "a read with attribution off took field-cost timestamps")
        chunks = len(data.batches)
        if not self.rehearsal:
            # the decode's one synchronize a chunk (ColumnarDecoder.
            # _decode_device), as before this plane existed
            check(syncs == chunks, f"plain exp1 read: {syncs} "
                  f"synchronizes for {chunks} chunks")
            check(launches["fused_decode"] == chunks,
                  f"plain exp1 read: fused launches {launches}")
        digest, _ = self._digest(data)
        raw = self.raw_reads.get("exp1")
        if raw is not None:
            check(digest == raw["digest"],
                  "plain exp1 read: planes differ from phase 9's read")
        table = data.to_arrow()
        ref = dict(digest=digest, launches=launches, syncs=syncs,
                   chunks=chunks, table=table,
                   mb_per_s=size / timing["read"] / 1e6)
        check(fieldcost.timer_calls() == timers,
              "to_arrow with attribution off took field-cost timestamps")
        self.p17["plain"] = {k: v for k, v in ref.items() if k != "table"}
        log(f"[obs] {self.card}: exp1 attribution off: {size / timing['read'] / 1e6:.1f} "
            f"MB/s; {syncs} synchronizes for {chunks} chunks; no timer "
            f"call; launches {json.dumps(launches)}")
        return ref

    def _p17_exp1(self, path, size, mode, ref):
        """(a) exp1 with explain=True, trace_file and a progress callback,
        then to_arrow: planes, table and launches equal the untraced
        read's; the decode plane within 15% of the decode stage's busy
        time; the assemble plane > 0; the trace's parentage and
        tools/traceview.py's summary; progress monotonic to the file's
        bytes; the registry's scan counters."""
        from cobrix_tpu_torch import prometheus_text, read_cobol
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        kw = {"device": "cpu"} if self.rehearsal else {}
        extra = ({} if mode == "sequential" else
                 {"pipeline_workers": "2",
                  "chunk_size_mb": self.pipe_chunk_mb})
        trace = os.path.join(self.tmp, f"obs_exp1_{mode}.json")
        snaps, timing = [], {}

        def run():
            t0 = time.perf_counter()
            with self._p17_syncs() as syncs:
                rep = read_cobol(path, copybook_contents=EXP1_COPYBOOK,
                                 explain=True, trace_file=trace,
                                 progress_callback=snaps.append,
                                 progress_interval_s="0", **extra, **kw)
            self.sync()
            timing["read"] = time.perf_counter() - t0
            timing["syncs"] = syncs[0]
            t0 = time.perf_counter()
            table = rep.data.to_arrow()
            self.sync()
            timing["arrow"] = time.perf_counter() - t0
            return rep, table
        (rep, table), launches = self._p17_count(f"exp1_{mode}", run)
        syncs = timing["syncs"]
        data = rep.data
        what = f"exp1 {mode} traced"
        if mode == "sequential" and not self.rehearsal:
            # attribution and tracing add no synchronize
            check(syncs == ref["syncs"], f"{what}: {syncs} synchronizes, "
                  f"{ref['syncs']} with attribution off")
        check(self._digest(data)[0] == ref["digest"],
              f"{what}: planes differ from the untraced read")
        check(table.schema.equals(ref["table"].schema, check_metadata=True)
              and table.equals(ref["table"]),
              f"{what}: table differs from the untraced read's")
        if not self.rehearsal:
            check(launches["fused_decode"] == ref["launches"]["fused_decode"]
                  == ref["chunks"], f"{what}: fused launches "
                  f"{launches['fused_decode']}, untraced "
                  f"{ref['launches']['fused_decode']}")
        stage = rep.decode_busy_s()
        attributed = rep.attributed_decode_s()
        check(stage and stage > 0, f"{what}: no decode stage time")
        share = attributed / stage
        check(abs(share - 1.0) <= 0.15, f"{what}: decode plane "
              f"{attributed:.4f} s of the decode stage's {stage:.4f} s")
        costs = rep.field_costs
        assemble = sum(v["assemble_s"] for v in costs.values())
        check(assemble > 0, f"{what}: no assemble plane after to_arrow")
        spans = self._p17_trace(trace, what,
                                "chunk" if extra else None)
        self._p17_progress(snaps, size, len(data), what)
        text = prometheus_text()
        for name in ("cobrix_scans_total", "cobrix_scan_bytes_total",
                     "cobrix_scan_records_total",
                     "cobrix_plan_cache_events_total",
                     "cobrix_record_length_bytes_count"):
            check(f"\n{name}" in text, f"{what}: {name} missing from "
                  f"prometheus_text()")
        # the untraced read of the same mode: (d), or phase 9's pipelined
        # read (None where phase 9 did not run)
        raw = self.raw_reads.get("exp1")
        plain = (ref["mb_per_s"] if mode == "sequential"
                 else raw["mb_per_s"][1] if raw is not None else None)
        mbps = size / timing["read"] / 1e6
        self.p17[f"exp1_{mode}"] = dict(
            read_s=timing["read"], to_arrow_s=timing["arrow"],
            mb_per_s=mbps, untraced_mb_per_s=plain,
            decode_stage_s=stage, decode_plane_s=attributed,
            decode_share=share, assemble_plane_s=assemble,
            spans=spans, snapshots=len(snaps), synchronizes=syncs,
            launches={k: v for k, v in launches.items() if v},
            top_fields=[(r["field"], r["kernel"], r["busy_s"])
                        for r in rep.top_fields(3)])
        log(f"[obs] {self.card}: exp1 {mode} traced + attributed: "
            f"{mbps:.1f} MB/s (untraced {mode}: "
            f"{'not run' if plain is None else f'{plain:.1f}'}); "
            f"to_arrow {timing['arrow']:.3f} s; decode plane "
            f"{attributed:.4f} s = {share:.3f} of the decode stage "
            f"{stage:.4f} s; assemble plane {assemble:.4f} s; "
            f"{len(snaps)} progress snapshots; spans {json.dumps(spans)}; "
            f"{syncs} synchronizes; launches "
            f"{json.dumps(self.p17['launches'][f'exp1_{mode}'])}")
        del data, table, rep

    def _p17_trace(self, trace, what, unit):
        """The trace file: Chrome JSON whose chunk (`unit`) or shard
        spans parent to the scan root and whose stage spans parent to
        them; tools/traceview.py summarizes it, unchanged. Returns the
        span counts by category."""
        sys.path.insert(0, os.path.join(HERE, "tools"))
        import traceview

        events = traceview.load_events(trace)
        summary = traceview.summarize(events)
        check(summary, f"{what}: traceview summary empty")
        spans = [e for e in events if e.get("ph") == "X"]
        by_cat = {}
        for e in spans:
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + 1
        roots = [e for e in spans if e["cat"] == "scan"]
        check(len(roots) == 1, f"{what}: {len(roots)} scan roots")
        root = roots[0]["args"]["span_id"]
        check(roots[0]["args"].get("field_costs"),
              f"{what}: the trace's root carries no field costs")
        phases = {e["name"] for e in spans if e["cat"] == "phase"}
        check({"parse_copybook", "scan"} <= phases,
              f"{what}: phases {sorted(phases)}")
        if unit is not None:
            units = [e for e in spans if e["cat"] == unit]
            check(units and all(u["args"]["parent_id"] == root
                                for u in units),
                  f"{what}: {unit} spans do not parent to the scan root")
            ids = {u["args"]["span_id"] for u in units}
            stages = [e for e in spans if e["cat"] == "stage"]
            check(stages and all(s["args"]["parent_id"] in ids
                                 for s in stages),
                  f"{what}: stage spans do not parent to a {unit} span")
        return by_cat

    def _p17_progress(self, snaps, size, records, what):
        check(snaps and snaps[-1].done, f"{what}: no final progress")
        for a, b in zip(snaps, snaps[1:]):
            check(b.bytes_done >= a.bytes_done
                  and b.records_done >= a.records_done
                  and b.chunks_done >= a.chunks_done,
                  f"{what}: progress went backwards")
        last = snaps[-1]
        check(last.bytes_done == last.bytes_total == size
              and last.records_done == records,
              f"{what}: final progress {last}")

    def _p17_rdw(self):
        """(b) the exp3 RDW file, sequential, with trace_file and
        field_costs: the shard span and its window (frame) and decode
        spans, the untraced read's planes and launches, the decode
        plane's 15% anchor."""
        from cobrix_tpu_torch import read_cobol
        from cobrix_tpu_torch.testing.generators import EXP3_COPYBOOK

        path = self.rdw_files["exp3"]
        size = os.path.getsize(path)
        kw = {"device": "cpu"} if self.rehearsal else {}
        trace = os.path.join(self.tmp, "obs_exp3.json")
        timing = {}

        def run():
            t0 = time.perf_counter()
            with self._p17_syncs() as syncs:
                data = read_cobol(path, copybook_contents=EXP3_COPYBOOK,
                                  trace_file=trace, field_costs="true",
                                  **RDW_OPTIONS, **kw)
            self.sync()
            timing["read"] = time.perf_counter() - t0
            timing["syncs"] = syncs[0]
            return data
        data, launches = self._p17_count("exp3", run)
        syncs = timing["syncs"]
        what = "exp3 traced"
        want = self.launches["rdw_exp3"]
        if not self.rehearsal:
            for k in READ_KERNELS:
                check(launches[k] == want[k], f"{what}: {k} launched "
                      f"{launches[k]} times, untraced {want[k]}")
        raw = self.raw_reads.get("exp3")
        if raw is not None:
            check(self._digest(data)[0] == raw["digest"],
                  f"{what}: planes differ from phase 9's read")
        stage = data.metrics.stage_busy.as_dict()["decode"]
        attributed = data.metrics.field_costs_acc.decode_busy_s()
        share = attributed / stage
        check(abs(share - 1.0) <= 0.15, f"{what}: decode plane "
              f"{attributed:.4f} s of the decode stage's {stage:.4f} s")
        spans = self._p17_trace(trace, what, "shard")
        check(spans.get("shard", 0) >= 1 and spans.get("stage", 0) >= 2,
              f"{what}: spans {spans}")
        mbps = size / timing["read"] / 1e6
        # the untraced sequential read: phase 9's (warm), else phase 4's
        # (the process's first read of the file)
        plain, plain_src = ((raw["mb_per_s"][0], "phase 9") if raw
                            else (size / self.rdw_e2e["exp3"][1] / 1e6,
                                  "phase 4"))
        self.p17["exp3"] = dict(
            read_s=timing["read"], mb_per_s=mbps, untraced_mb_per_s=plain,
            decode_stage_s=stage, decode_plane_s=attributed,
            decode_share=share, spans=spans, synchronizes=syncs,
            launches={k: v for k, v in launches.items() if v})
        log(f"[obs] {self.card}: exp3 traced + attributed: {mbps:.1f} MB/s "
            f"(untraced, {plain_src}: {plain:.1f}); decode plane "
            f"{attributed:.4f} s = {share:.3f} of the decode stage "
            f"{stage:.4f} s; spans {json.dumps(spans)}; {syncs} "
            f"synchronizes; launches "
            f"{json.dumps(self.p17['launches']['exp3'])}")
        del data

    # -- phase 18: the statistics plane --------------------------------

    def phase_stats(self):
        """Phase 18: the statistics plane on the card (see the module
        docstring): (a) exp1's profile, (b) fixed-length chunk skipping
        on the TXN corpus, (c) RDW shard skipping on the multisegment
        corpus (C10 at full size), (d) aggregates from the profile."""
        t_phase = time.perf_counter()
        self.p18 = {"launches": {}, "reads": {}}
        self.p18_launches = dict.fromkeys(KERNELS, 0)
        self._p18_exp1()
        txn = self._p18_txn()
        self._p18_multiseg()
        self._p18_dataset(*txn)
        self.launches["stats"] = dict(self.p18_launches)
        if not self.rehearsal:
            for k in READ_KERNELS + ARROW_KERNELS:
                check(self.p18_launches[k] > 0,
                      f"{k} never launched on the statistics path")
        self.p18["secs"] = time.perf_counter() - t_phase
        log(f"[stats] {self.card}: phase 18 {self.p18['secs']:.1f} s; "
            f"launches on the statistics path "
            f"{json.dumps(self.p18_launches)}")

    def _p18_read(self, tag, path, stats=True, arrow=True, **opts):
        """read_cobol on the default device (and its table unless
        `arrow` is false), every kernel's launches counted from 0:
        (data, table, read seconds, launches). A read with a stats
        option joins the statistics path under `tag`; its stats-off twin
        (`stats` false) is a reference and joins nothing."""
        from cobrix_tpu_torch import read_cobol

        kw = {"device": "cpu"} if self.rehearsal else {}
        timing = {}

        def run():
            t0 = time.perf_counter()
            data = read_cobol(path, **opts, **kw)
            self.sync()
            timing["read"] = time.perf_counter() - t0
            return data, (data.to_arrow() if arrow else None)
        (data, table), launches = self._p16_count(run)
        if stats:
            for k, v in launches.items():
                if k in self.p18_launches:
                    self.p18_launches[k] += v
            self.p18["launches"][tag] = {k: v for k, v in launches.items()
                                         if v}
        return data, table, timing["read"], launches

    def _p18_report(self, tag, size, data, secs, launches, twin=None):
        """Log one read of phase 18: its MB/s (beside its stats-off
        twin's (data, seconds) when given), the profiling pass's
        seconds, the chunk counters and the launches."""
        collect_s = data.metrics.timings_s.get("collect_stats")
        scan_s = secs - (collect_s or 0.0)
        pd = data.metrics.pushdown or {}
        row = dict(mb_per_s=size / scan_s / 1e6, read_s=secs,
                   collect_s=collect_s, rows=len(data),
                   chunks_considered=pd.get("chunks_considered"),
                   chunks_skipped=pd.get("chunks_skipped"),
                   bytes_skipped=pd.get("bytes_skipped"),
                   launches={k: v for k, v in launches.items() if v})
        if twin is not None:
            row["stats_off_mb_per_s"] = size / twin[1] / 1e6
        self.p18["reads"][tag] = row
        beside = ("" if twin is None else
                  f" (stats off {row['stats_off_mb_per_s']:.1f})")
        extra = ("" if collect_s is None else
                 f"; profiling pass {collect_s:.3f} s apart from the "
                 f"read's {scan_s:.3f} s")
        log(f"[stats] {self.card}: {tag}: {row['rows']} rows, "
            f"{row['mb_per_s']:.1f} MB/s{beside}{extra}; chunks "
            f"{row['chunks_skipped']}/{row['chunks_considered']} skipped, "
            f"{row['bytes_skipped']} bytes; launches "
            f"{json.dumps(row['launches'])}")
        return row

    @staticmethod
    def _p18_payloads(cache):
        """{url: profile payload} of the stats entries under `cache`."""
        from cobrix_tpu_torch.testing.faults import cache_entry_paths

        out = {}
        for path in cache_entry_paths(cache, "stats"):
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)["profile"]
            out[doc["url"]] = doc
        return out

    def _p18_chunks(self, size, rs, grid_mb):
        """The profile's chunk count of a fixed-length file: strides of
        `grid_mb` MB, record-aligned."""
        stride = max(rs, int(float(grid_mb) * 1024 * 1024) // rs * rs)
        return -(-size // stride)

    def _p18_exp1(self):
        """(a) the phase 3 exp1 file profiled at the default 4 MB grid:
        one fused launch and one launch of each assembly kernel a chunk
        in the profiling pass, none on a warm re-read; the profile of
        the first 64 MiB of records on the card equals the CPU's."""
        from cobrix_tpu_torch.api import parse_options
        from cobrix_tpu_torch.stats.collect import build_and_store_profiles
        from cobrix_tpu_torch.testing.generators import EXP1_COPYBOOK

        rs = 1493
        path, size = self.exp1_path, self.e2e[0]
        if os.path.getsize(path) != size:
            # phase 12 (c) left a torn tail on it: the phase 3 bytes
            os.truncate(path, size)
        grid = {"stats_chunk_mb": "0.5"} if self.rehearsal else {}
        want_chunks = self._p18_chunks(size, rs, grid.get(
            "stats_chunk_mb", "4"))
        cb = dict(copybook_contents=EXP1_COPYBOOK)
        off, _, off_s, twin = self._p18_read("exp1_off", path, stats=False,
                                             arrow=False, **cb)
        cache = os.path.join(self.tmp, "p18_exp1")
        data, _, secs, launches = self._p18_read(
            "exp1_collect", path, arrow=False, cache_dir=cache,
            collect_stats="true", **cb, **grid)
        self._p18_report("exp1_collect", size, data, secs, launches,
                         (off, off_s))
        prof = data.stats_profiles[path]
        pass_launches = {k: launches[k] - twin[k] for k in launches}
        check(prof["chunks"] == want_chunks and prof["records"] == size // rs,
              f"exp1 profile: {prof['chunks']} chunks, {prof['records']} "
              f"records; want {want_chunks}")
        check(pass_launches["fused_decode"] == want_chunks,
              f"exp1 profiling pass: {pass_launches} for {want_chunks} "
              "chunks")
        if not self.rehearsal:
            for k in ARROW_KERNELS:
                check(pass_launches[k] == want_chunks,
                      f"exp1 profiling pass: {k} {pass_launches[k]} for "
                      f"{want_chunks} chunks")
        warm, _, warm_s, warm_launches = self._p18_read(
            "exp1_collect_warm", path, arrow=False, cache_dir=cache,
            collect_stats="true", **cb, **grid)
        self._p18_report("exp1_collect_warm", size, warm, warm_s,
                         warm_launches, (off, off_s))
        check(warm_launches == twin,
              f"the warm profile pass launched: {warm_launches} against "
              f"the stats-off read's {twin}")
        check(warm.stats_profiles == data.stats_profiles,
              "the warm profile differs from the collected one")
        del off, data, warm
        # the profile of the first 64 MiB of records, card against CPU
        n = 1000 if self.rehearsal else (64 << 20) // rs
        head = os.path.join(self.tmp, "p18_exp1_head.dat")
        with open(path, "rb") as src, open(head, "wb") as dst:
            dst.write(src.read(n * rs))
        caches = {k: os.path.join(self.tmp, f"p18_head_{k}")
                  for k in ("card", "cpu")}
        t0 = time.perf_counter()
        self._p18_read("exp1_head", head, arrow=False,
                       cache_dir=caches["card"], collect_stats="true",
                       **cb, **grid)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_and_store_profiles([head], EXP1_COPYBOOK, parse_options(dict(
            cache_dir=caches["cpu"], collect_stats="true", **grid)), "cpu")
        cpu_s = time.perf_counter() - t0
        got, want = (self._p18_payloads(caches[k]) for k in ("card", "cpu"))
        check(list(got) == [head] and got == want,
              "the card's exp1 profile differs from the CPU's")
        self.p18["exp1"] = dict(chunks=want_chunks,
                                pass_launches=pass_launches,
                                head_records=n, head_chunks=len(
                                    got[head]["chunks"]),
                                head_card_s=card_s, head_cpu_s=cpu_s)
        log(f"[stats] exp1: profiling pass {json.dumps(pass_launches)} "
            f"launches for {want_chunks} chunks, none warm; the profile of "
            f"the first {n} records ({len(got[head]['chunks'])} chunks) on "
            f"the card == on the CPU, value for value (card read + pass "
            f"{card_s:.1f} s, CPU pass {cpu_s:.1f} s)")
        os.remove(head)

    def _p18_txn(self):
        """(b) the TXN corpus (TXN-ID rising): collected, then read with
        use_stats under a 1-record filter (>= 90% of the chunks skipped)
        and under a filter the zone maps cannot prove (nothing skipped),
        sequential and pipelined: tables equal the stats-off reads'.
        Returns (path, cache, read options) for (d)."""
        from cobrix_tpu_torch.testing import corpus

        n = 60_000 if self.rehearsal else 8_000_000
        path = os.path.join(self.tmp, "p18_txn.dat")
        t0 = time.perf_counter()
        info = corpus.write_fixed_corpus(path, n, seed=7)
        size, rs = info["bytes"], info["record_size"]
        log(f"[stats] wrote {n} TXN records ({size} bytes) in "
            f"{time.perf_counter() - t0:.1f} s")
        grid = {"stats_chunk_mb": "0.1"} if self.rehearsal else {}
        opts = corpus.fixed_read_options()
        cache = os.path.join(self.tmp, "p18_txn")
        data, _, secs, launches = self._p18_read(
            "txn_collect", path, arrow=False, cache_dir=cache,
            collect_stats="true", **opts, **grid)
        self._p18_report("txn_collect", size, data, secs, launches)
        chunks = data.stats_profiles[path]["chunks"]
        check(chunks == self._p18_chunks(size, rs, grid.get(
            "stats_chunk_mb", "4")), f"TXN profile: {chunks} chunks")
        del data
        modes = {"sequential": {},
                 "pipelined": {"pipeline_workers": "2",
                               "chunk_size_mb": self.pipe_chunk_mb}}
        for label, flt in (("selective", f"TXN_ID == {n // 2}"),
                           ("unprovable", "STATUS == 'A'")):
            for mode, extra in modes.items():
                tag = f"txn_{label}_{mode}"
                twin = self._p18_read(tag + "_off", path, stats=False,
                                      filter=flt, **opts, **extra)
                data, table, secs, launches = self._p18_read(
                    tag, path, cache_dir=cache, use_stats="true",
                    filter=flt, **opts, **grid, **extra)
                row = self._p18_report(tag, size, data, secs, launches,
                                       (twin[0], twin[2]))
                check(table.equals(twin[1]), f"{tag}: the table differs "
                      "from the stats-off read's")
                considered = row["chunks_considered"]
                kept = considered - row["chunks_skipped"]
                check(considered == chunks, f"{tag}: {considered} chunks "
                      f"considered of {chunks}")
                # the filter's two stages a kept chunk: stage 1 packs
                # the filter column and decodes it (TXN-ID in the fused
                # kernel; STATUS, a string, outside it), stage 2 packs
                # and decodes the chunk's kept records
                if label == "selective":
                    check(table.num_rows == 1 and kept <= 0.1 * chunks,
                          f"{tag}: {table.num_rows} rows, {kept} of "
                          f"{chunks} chunks kept")
                    want = {"fused_decode": kept + 1,
                            "pack_records": kept + 1}
                else:
                    check(kept == chunks and table.num_rows > 0,
                          f"{tag}: {kept} of {chunks} chunks kept")
                    want = {"fused_decode": kept, "pack_records": 2 * kept}
                got = {k: launches[k] for k in want}
                check(got == want, f"{tag}: launches {got}, want {want}")
                del twin, data, table
        return path, cache, dict(opts, **grid)

    def _p18_multiseg(self):
        """(c) the multisegment RDW corpus in 4 MB index shards:
        collected, then read with use_stats under a selective filter
        (some shards skipped) and an impossible one (every shard
        skipped: no scan, pack or fused launch; the sequential read is
        C10), sequential and pipelined: tables equal the stats-off
        reads'."""
        from cobrix_tpu_torch.testing import corpus

        n = 20_000 if self.rehearsal else 1_000_000
        path = os.path.join(self.tmp, "p18_multiseg.dat")
        t0 = time.perf_counter()
        info = corpus.write_multiseg_corpus(path, n, seed=7)
        size = info["bytes"]
        log(f"[stats] wrote {n} companies, {info['records']} records "
            f"({size} bytes) in {time.perf_counter() - t0:.1f} s")
        split = ({"input_split_records": "5000"} if self.rehearsal
                 else {"input_split_size_mb": "4"})
        opts = dict(corpus.multiseg_read_options(), **split)
        cache = os.path.join(self.tmp, "p18_multiseg")
        data, _, secs, launches = self._p18_read(
            "multiseg_collect", path, arrow=False, cache_dir=cache,
            collect_stats="true", **opts)
        self._p18_report("multiseg_collect", size, data, secs, launches)
        chunks = data.stats_profiles[path]["chunks"]
        check(chunks > 1 and data.stats_profiles[path]["records"]
              == info["records"], f"multiseg profile: {chunks} chunks")
        del data
        modes = {"sequential": {}, "pipelined": {"pipeline_workers": "2"}}
        for label, flt in (("selective", f"COMPANY_ID == 'C{n // 2:09d}'"),
                           ("impossible", "COMPANY_ID == 'Z'")):
            for mode, extra in modes.items():
                tag = f"multiseg_{label}_{mode}"
                twin = self._p18_read(tag + "_off", path, stats=False,
                                      filter=flt, **opts, **extra)
                data, table, secs, launches = self._p18_read(
                    tag, path, cache_dir=cache, use_stats="true",
                    filter=flt, **opts, **extra)
                row = self._p18_report(tag, size, data, secs, launches,
                                       (twin[0], twin[2]))
                check(table.equals(twin[1]), f"{tag}: the table differs "
                      "from the stats-off read's")
                considered = row["chunks_considered"]
                skipped = row["chunks_skipped"]
                check(considered == chunks, f"{tag}: {considered} shards "
                      f"considered of {chunks}")
                if label == "selective":
                    check(0 < skipped < considered and table.num_rows >= 1,
                          f"{tag}: {skipped} of {considered} skipped")
                else:
                    check(skipped == considered and table.num_rows == 0,
                          f"{tag}: {skipped} of {considered} skipped, "
                          f"{table.num_rows} rows")
                    read = ("rdw_scan", "pack_records", "fused_decode")
                    check(not any(launches[k] for k in read),
                          f"{tag}: launches {launches} with every shard "
                          "skipped")
                del twin, data, table
        os.remove(path)

    def _p18_dataset(self, path, cache, opts):
        """(d) query.dataset over the TXN corpus with use_stats: the
        aggregates from the profile equal the decode path's, types
        included, and launch nothing."""
        from cobrix_tpu_torch.query import dataset

        kw = {"device": "cpu"} if self.rehearsal else {}
        aggs = ["count", "min:TXN_ID", "max:TXN_ID", "sum:AMOUNT",
                "min:ACCOUNT", "max:CURRENCY", "sum:BRANCH"]

        def timed(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0
        ds = dataset(path, cache_dir=cache, use_stats="true", **opts, **kw)
        (fast, fast_s), launches = self._p16_count(
            lambda: timed(lambda: ds.aggregate(aggs)))
        check(not any(launches.values()),
              f"the stats-answered aggregate launched {launches}")
        plain_ds = dataset(path, **opts, **kw)
        (plain, plain_s), plain_launches = self._p16_count(
            lambda: timed(lambda: plain_ds.aggregate(aggs)))
        check(fast == plain and [type(fast[k]) for k in aggs]
              == [type(plain[k]) for k in aggs],
              f"aggregates from the profile {fast} vs decoded {plain}")
        self.p18["dataset"] = dict(stats_s=fast_s, decode_s=plain_s,
                                   decode_launches={
                                       k: v for k, v in
                                       plain_launches.items() if v})
        log(f"[stats] {self.card}: dataset aggregate from the profile in "
            f"{fast_s:.3f} s, no launch == the decode path's in "
            f"{plain_s:.3f} s (launches "
            f"{json.dumps(self.p18['dataset']['decode_launches'])}): "
            f"{json.dumps({k: str(v) for k, v in fast.items()})}")
        os.remove(path)

    def run(self):
        if self.only:
            # a subset: the environment, the RDW files, then the phases
            # named (each needs the files phase 4 writes)
            try:
                self.phase_env()
                self.pipe_chunk_mb = "0.25" if self.rehearsal else "64"
                if {"14", "15", "16", "17", "18"} & set(self.only):
                    self.phase_main()
                self.phase_rdw()
                if "14" in self.only:
                    self.phase_exp3()
                for name in self.only:
                    getattr(self, PHASES[name])()
            finally:
                shutil.rmtree(self.tmp, ignore_errors=True)
            return
        try:
            for name in ("env", "grid", "framing_grid", "main", "rdw",
                         "exp3", "timings", "rdw_timings", "profile",
                         "pipeline", "query", "arrow", "recovery",
                         "generic", "hierarchical", "assembly", "io",
                         "pushdown", "obs", "stats"):
                t0 = time.perf_counter()
                getattr(self, f"phase_{name}")()
                self.phase_secs[name] = time.perf_counter() - t0
                log(f"[phases] phase_{name}: "
                    f"{self.phase_secs[name]:.1f} s")
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)

    def result_lines(self):
        torch = self.torch
        t = self.timings["exp1"]
        by_path = {k: {path: n[k] for path, n in self.launches.items()
                       if k in n} for k in KERNELS}
        # the headline times are exp3's window and its widest segment, as
        # in earlier runs; `shapes` holds every timed shape
        scans = [self.rdw_timings[k]["scan"] for k in ("exp3", "exp2")]
        packs = [p for k in ("exp3", "exp2")
                 for p in self.rdw_timings[k]["packs"]]
        scan = scans[0]
        pack = next(p for p in packs if p["window"] == "exp3"
                    and p["pack"] == "widest_segment")
        entries = [
            dict(name="fused_decode", route="cuda", source=KERNEL_SOURCE,
                 replaces=REPLACES, ms=t["kernel_ms"],
                 device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], library_ms=None),
            dict(name="rdw_scan", route="cuda", source=FRAMING_SOURCE,
                 replaces=SCAN_REPLACES, ms=scan["ms"],
                 plain_ms=scan["plain_ms"], bound_ms=scan["bound_ms"],
                 library_ms=None, shapes=scans),
            dict(name="pack_records", route="cuda", source=FRAMING_SOURCE,
                 replaces=PACK_REPLACES, ms=pack["ms"],
                 plain_ms=pack["plain_ms"], bound_ms=pack["bound_ms"],
                 library_ms=pack["library_ms"], shapes=packs),
        ]
        # the query path: the scan's capped mode and the pipeline's pack
        # join their kernels' shapes; the aggregate's headline is the
        # block query's shape
        pipe = self.query["pipeline"]
        entries[1]["shapes"] = scans + [dict(mode="capped",
                                             **pipe["capped_scan"])]
        entries[2]["shapes"] = packs + [dict(pack="on_hbm_pipeline",
                                             **pipe["pack"])]
        agg = self.query["aggregate"][0]
        entries.append(dict(
            name="aggregate", route="cuda", source=AGG_SOURCE,
            replaces=AGG_REPLACES, ms=agg["ms"], device_ms=agg["device_ms"],
            plain_ms=agg["plain_ms"], bound_ms=agg["bound_ms"],
            library_ms=None, shapes=self.query["aggregate"],
            max_rel_err_sums=self.agg_rel_err,
            modes_held=self.agg_modes_held))
        # the assembly's kernels: headline at the exp1 chunk, every
        # timed shape beside it
        for name in ARROW_KERNELS:
            shapes = [dict(shape=r["shape"], rows=r["rows"],
                           **r["steps"][name])
                      for r in self.asm14["times"] if name in r["steps"]]
            head = shapes[0]
            entries.append(dict(
                name=name, route="cuda", source=ARROW_SOURCE,
                replaces=ARROW_REPLACES[name], ms=head["ms"],
                device_ms=head["device_ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], library_ms=None, shapes=shapes,
                plans_held=self.asm14["held"][name]))
        for e in entries:
            e.update(launches=sum(by_path[e["name"]].values()),
                     launches_by_path=by_path[e["name"]],
                     max_abs_err=self.max_err[e["name"]], bound_by="bytes")
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
        phases = {k: round(v, 1) for k, v in self.phase_secs.items()}
        return ["[phases] " + json.dumps(phases, separators=(",", ":")),
                self.card, json.dumps({"kernels": entries}),
                json.dumps({"ok": True, "device": device})]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="small run on the CPU with the plain versions; "
                             "exits 3 without result lines")
    parser.add_argument("--phases", default="",
                        help="run only these phases (comma-separated: "
                             + ", ".join(sorted(PHASES)) + "), after the "
                             "environment and phase 4; exits 3 without "
                             "result lines")
    args = parser.parse_args(argv)
    bad = [p for p in args.phases.split(",") if p and p not in PHASES]
    if bad:
        parser.error(f"unknown phases {bad}")
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
    finally:
        left = stop_children()
        if left:
            print(f"chip_smoke: stopped child processes {left}",
                  file=sys.stderr)
    if args.cpu_rehearsal or smoke.only:
        log("[rehearsal] all phases passed on the CPU; no result lines"
            if args.cpu_rehearsal else
            f"[phases] phases {args.phases} passed; no result lines")
        return 3
    for line in smoke.result_lines():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
