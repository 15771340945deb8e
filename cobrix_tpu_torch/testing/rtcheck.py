"""Round-trip property check: copybook-driven encode vs the readers.

The port's counterpart of the JAX package's ``tools/rtcheck.py``, as a
module of the package. The encoder (`cobrix_tpu_torch.encode`) claims
byte-compatibility with the decode path. This check enforces three
properties end to end through `encode_file` -> `read_cobol` ->
`CobolData.to_ebcdic`, every read on `device` (the CUDA device unless
given ``device="cpu"``, like every entry point):

  P1 (value round-trip)  decode(encode(body)) == body for every body
     drawn from the canonical value domain (`testing.genspec`);
  P2 (byte stability)    re-encoding the decoded rows reproduces the
     original file byte for byte;
  P3 (alias canonicalization)  RAW bytes — including duplicate-glyph
     alias bytes the encoder can never emit — reach a canonical fixed
     point after ONE decode→encode round: the re-encoded file decodes
     to the same rows and re-encodes to the same bytes (deterministic
     lowest-byte-wins inversion on every builtin code page).

Quick mode runs a deterministic seed matrix over both framings (fixed
and RDW), then the alias matrix. `--sweep N` fuzzes N random copybooks
(default 120) with fresh random bodies each; any failure is SHRUNK to a
minimal (copybook, record) reproduction before printing, so a red run
ends with a paste-able repro.

    python -m cobrix_tpu_torch.testing.rtcheck                # on the card
    python -m cobrix_tpu_torch.testing.rtcheck --device cpu   # plain versions
    python -m cobrix_tpu_torch.testing.rtcheck --sweep 150
    python -m cobrix_tpu_torch.testing.rtcheck --sweep 1 --seed 42

Exit code 0 = every property holds everywhere; 1 = any failure.
"""
from __future__ import annotations

import argparse
import os
import random
import sys
import tempfile


def _read_back(spec, data: bytes, framing: str, device=None):
    from .. import read_cobol

    with tempfile.NamedTemporaryFile(suffix=".dat", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        out = read_cobol(path, device=device, **spec.read_options(framing))
        rows = out.to_rows()
        rebytes = out.to_ebcdic(
            framing=framing,
            variable_size_occurs=spec.has_depending)
        return rows, rebytes
    finally:
        os.unlink(path)


def roundtrip_failure(spec, bodies, framing: str, device=None):
    """None if P1 and P2 hold, else a short failure tag."""
    from ..encode import encode_file

    data = encode_file(spec.copybook_text, bodies,
                       **spec.encode_options(framing))
    rows, rebytes = _read_back(spec, data, framing, device)
    if [list(b) for b in rows] != [list(b) for b in bodies]:
        for i, (got, want) in enumerate(zip(rows, bodies)):
            if list(got) != list(want):
                return (f"P1 value mismatch at record {i}: "
                        f"decoded {got!r} != encoded {want!r}")
        return (f"P1 record count mismatch: decoded {len(rows)} "
                f"!= encoded {len(bodies)}")
    if rebytes != data:
        n = min(len(rebytes), len(data))
        at = next((i for i in range(n) if rebytes[i] != data[i]), n)
        return (f"P2 byte instability at offset {at}: re-encode gives "
                f"{len(rebytes)} bytes vs {len(data)} original")
    return None


ALIAS_CODE_PAGES = ("common", "common_extended", "cp037",
                    "cp037_extended", "cp500", "cp500_extended",
                    "cp875", "cp1047", "cp1047_extended")

# the P1/P2 fuzz rotation: every Latin-1 page takes seeds (cp875's
# Greek alphabet needs genspec's safe-alphabet filtering, exercised by
# the alias matrix instead)
FUZZ_CODE_PAGES = ("common", "cp037", "cp500", "cp1047")


def alias_roundtrip_failure(code_page: str, raw: bytes,
                            width: int = 16, device=None):
    """P3 for one raw byte image on one code page: decode the raw
    bytes through a PIC X(width) reader, re-encode, and demand the
    canonical fixed point — decode(canon) == decode-after-one-round
    and re-encoding reproduces `canon` byte for byte. None if P3
    holds, else a short failure tag."""
    from .. import read_cobol

    copybook = f"""
       01  R.
           05  S  PIC X({width}).
"""
    if len(raw) % width:
        raw = raw + b"\x40" * (width - len(raw) % width)

    def decode_reencode(data: bytes):
        with tempfile.NamedTemporaryFile(suffix=".dat",
                                         delete=False) as f:
            f.write(data)
            path = f.name
        try:
            out = read_cobol(path, copybook_contents=copybook,
                             ebcdic_code_page=code_page, device=device)
            return out.to_rows(), out.to_ebcdic(framing="fixed")
        finally:
            os.unlink(path)

    rows1, canon = decode_reencode(raw)
    rows2, stable = decode_reencode(canon)
    if rows2 != rows1:
        return (f"P3 value instability on {code_page}: canonical "
                f"bytes decode to different rows than the raw image")
    if stable != canon:
        n = min(len(stable), len(canon))
        at = next((i for i in range(n) if stable[i] != canon[i]), n)
        return (f"P3 alias bytes on {code_page} do not reach a fixed "
                f"point after one round (first divergence at byte "
                f"{at})")
    return None


def run_alias_matrix(seeds=(0, 1, 2), device=None) -> int:
    """P3 over every builtin code page: the full byte space (all 256
    values, so every duplicate-glyph alias byte is exercised) plus a
    few random images per page. Returns the failures."""
    failures = 0
    cases = 0
    every_byte = bytes(range(256))
    for code_page in ALIAS_CODE_PAGES:
        images = [every_byte]
        for seed in seeds:
            rng = random.Random(7000 + seed)
            images.append(bytes(rng.randrange(256)
                                for _ in range(16 * 24)))
        for raw in images:
            cases += 1
            failure = alias_roundtrip_failure(code_page, raw,
                                              device=device)
            if failure:
                failures += 1
                print(f"FAIL code_page={code_page}: {failure}")
    print(f"rtcheck alias: {cases} raw images over "
          f"{len(ALIAS_CODE_PAGES)} code pages, {failures} failure(s)")
    return failures


def _framing_for(spec, rng=None) -> str:
    if spec.has_depending:
        return "rdw"  # variable_size_occurs needs variable-length records
    if rng is None:
        return "fixed"
    return rng.choice(["fixed", "rdw"])


def _shrink_and_report(spec, bodies, framing: str, failure: str,
                       seed, device=None) -> None:
    from . import genspec

    print(f"FAIL seed={seed} framing={framing}: {failure}")

    def fails(candidate, rows) -> bool:
        return roundtrip_failure(candidate, rows, framing,
                                 device) is not None

    # isolate the failing record first, then shrink the pair
    row = bodies[0]
    for body in bodies:
        if fails(spec, [body]):
            row = body
            break

    def spec_fails(candidate) -> bool:
        return fails(candidate, [candidate.trivial_body()])

    # shrink the copybook only if the failure reproduces on the
    # trivial body (a pure schema bug); otherwise keep the schema and
    # shrink the record
    if spec_fails(spec):
        spec = genspec.shrink_spec(spec, spec_fails)
        row = spec.trivial_body()
    row = genspec.shrink_body(spec, row, lambda r: fails(spec, [r]))
    final = roundtrip_failure(spec, [row], framing, device)
    print("---- minimal reproduction ----")
    print(spec.copybook_text)
    print(f"framing: {framing}")
    print(f"record body: {row!r}")
    print(f"failure: {final or failure}")
    print("------------------------------")


def quick_cases():
    """The quick matrix's (seed, spec, bodies, framing), in order: 12
    seeded copybooks over every fuzzable code page and both framings,
    the same draws as the JAX package's ``tools/rtcheck.py``."""
    from .genspec import CopybookSpec

    out = []
    for seed in range(12):
        rng = random.Random(1000 + seed)
        spec = CopybookSpec.random(
            rng, code_page=FUZZ_CODE_PAGES[seed % len(FUZZ_CODE_PAGES)])
        bodies = [spec.random_body(rng) for _ in range(3)]
        out.append((1000 + seed, spec, bodies, _framing_for(spec, rng)))
    return out


def run_quick(device=None) -> int:
    """Deterministic seed matrix (both framings, every fuzzable code
    page, every grammar feature reachable from the seeds), then the
    alias matrix. Returns the failures."""
    failures = 0
    cases = quick_cases()
    for seed, spec, bodies, framing in cases:
        failure = roundtrip_failure(spec, bodies, framing, device)
        if failure:
            failures += 1
            _shrink_and_report(spec, bodies, framing, failure, seed,
                               device)
    print(f"rtcheck quick: {len(cases)} copybooks, "
          f"{failures} failure(s)")
    return failures + run_alias_matrix(device=device)


def run_sweep(n: int, base_seed: int, device=None) -> int:
    """`n` random copybooks from `base_seed` on; returns the
    failures."""
    from .genspec import CopybookSpec

    failures = 0
    for i in range(n):
        seed = base_seed + i
        rng = random.Random(seed)
        spec = CopybookSpec.random(
            rng, max_fields=10,
            code_page=rng.choice(list(FUZZ_CODE_PAGES)))
        bodies = [spec.random_body(rng) for _ in range(4)]
        framing = _framing_for(spec, rng)
        try:
            failure = roundtrip_failure(spec, bodies, framing, device)
        except Exception as exc:
            failure = f"exception: {type(exc).__name__}: {exc}"
        if failure:
            failures += 1
            try:
                _shrink_and_report(spec, bodies, framing, failure, seed,
                                   device)
            except Exception as exc:
                print(f"FAIL seed={seed} (shrink aborted: {exc})")
        if (i + 1) % 25 == 0:
            print(f"  ... {i + 1}/{n} copybooks, {failures} failure(s)")
    print(f"rtcheck sweep: {n} copybooks, {failures} failure(s)")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", type=int, nargs="?", const=120,
                    default=None, metavar="N",
                    help="fuzz N random copybooks (default 120)")
    ap.add_argument("--seed", type=int, default=2000,
                    help="base seed for --sweep (default 2000)")
    ap.add_argument("--device", default=None,
                    help="the reads' device (default: the CUDA device; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    failures = (run_sweep(args.sweep, args.seed, args.device)
                if args.sweep is not None else run_quick(args.device))
    if failures:
        print("rtcheck: FAILURES — see minimal reproductions above")
        return 1
    print("rtcheck: encode/decode round-trip properties hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
