"""The port stands alone, and its plan is the JAX package's plan.

* Isolation: no module of ``cobrix_tpu_torch`` (nor ``chip_smoke.py``)
  imports jax, jaxlib or cobrix_tpu; a process that imports the port and
  decodes exp1 on the CPU never loads them; and the entry points refuse
  to run on the CPU unless asked to.
* Plan parity: ``compile_plan`` of both packages, column for column, on
  the exp1/exp3 profiles and a few of the repo's test copybooks, and the
  same line-tagged error for a malformed PIC.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import cobrix_tpu_torch
from cobrix_tpu import parse_copybook as jax_parse
from cobrix_tpu.plan.compiler import compile_plan as jax_compile
from cobrix_tpu.reader.columnar import _variant_key as jax_variant_key
from cobrix_tpu.testing import generators as jgen
from cobrix_tpu_torch import parse_copybook as port_parse
from cobrix_tpu_torch.plan.compiler import compile_plan as port_compile
from cobrix_tpu_torch.reader.columnar import _variant_key as port_variant_key
from cobrix_tpu_torch.testing import generators as pgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "cobrix_tpu")


def _port_sources():
    pkg = os.path.join(REPO, "cobrix_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".") for m in FORBIDDEN)


def test_no_module_imports_jax_or_the_jax_package():
    seen = 0
    packages = set()
    for path in _port_sources():
        packages.add(os.path.relpath(os.path.dirname(path), REPO))
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _forbidden(name), f"{path} imports {name}"
        seen += 1
    assert seen > 15
    # every subpackage is scanned, the device-resident query path too
    assert {os.path.join("cobrix_tpu_torch", p) for p in
            ("ops", "reader", "engine", "parallel", "io", "utils",
             "testing")} <= packages
    assert not _forbidden("cobrix_tpu_torch")
    assert not _forbidden("cobrix_tpu_torch.ops")


def test_decode_in_a_fresh_process_loads_neither():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from cobrix_tpu_torch import ColumnarDecoder, parse_copybook\n"
        "from cobrix_tpu_torch.testing.generators import (EXP1_COPYBOOK,"
        " generate_exp1)\n"
        "dec = ColumnarDecoder(parse_copybook(EXP1_COPYBOOK), device='cpu')\n"
        "b = dec.decode(generate_exp1(5, seed=2))\n"
        "assert len(b.to_rows()) == 5\n"
        "import gzip, os, tempfile\n"
        "import cobrix_tpu_torch as t\n"
        "from cobrix_tpu_torch.io import (blockcache, compress,\n"
        "    compress_index, config, fsspec_source, index_store,\n"
        "    integrity, prefetch, stats)\n"
        "from cobrix_tpu_torch.testing import corpus, faults\n"
        "from cobrix_tpu_torch.utils import atomic\n"
        "d = tempfile.mkdtemp()\n"
        "p = os.path.join(d, 'e.dat.gz')\n"
        "open(p, 'wb').write(gzip.compress(generate_exp1(7).tobytes()))\n"
        "r = t.read_cobol(p, copybook_contents=EXP1_COPYBOOK, device='cpu',\n"
        "                 cache_dir=os.path.join(d, 'c'))\n"
        "assert len(r) == 7 and r.metrics.as_dict()['io']\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib') or "
        "m.startswith(('jax.', 'jaxlib.', 'cobrix_tpu.')) or "
        "m == 'cobrix_tpu']\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_entry_points_default_to_cuda(tmp_path):
    path = tmp_path / "one.dat"
    path.write_bytes(pgen.generate_exp1(2, seed=1).tobytes())
    cb = port_parse(pgen.EXP1_COPYBOOK)
    if torch.cuda.is_available():
        assert cobrix_tpu_torch.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cobrix_tpu_torch.read_cobol(str(path),
                                    copybook_contents=pgen.EXP1_COPYBOOK)
    with pytest.raises(RuntimeError):
        cobrix_tpu_torch.ColumnarDecoder(cb)
    with pytest.raises(RuntimeError):
        cobrix_tpu_torch.ColumnarDecoder(cb, device="cuda")
    assert len(cobrix_tpu_torch.read_cobol(
        str(path), copybook_contents=pgen.EXP1_COPYBOOK, device="cpu")) == 2


def test_read_cobol_names_every_option_it_does_not_take(tmp_path):
    path = tmp_path / "one.dat"
    path.write_bytes(pgen.generate_exp1(2, seed=1).tobytes())
    # options of the JAX package's reader the port does not take (a key
    # neither package knows is ignored, or named by `pedantic`)
    for option in ("collect_stats", "heartbeat_interval_s", "use_stats",
                   "stream_batch_rows", "hosts"):
        with pytest.raises(ValueError, match=option):
            cobrix_tpu_torch.read_cobol(
                str(path), copybook_contents=pgen.EXP1_COPYBOOK,
                device="cpu", **{option: "1"})
    with pytest.raises(ValueError, match="schema_retention_policy"):
        cobrix_tpu_torch.read_cobol(
            str(path), copybook_contents=pgen.EXP1_COPYBOOK, device="cpu",
            schema_retention_policy="flatten")
    # taken since the statistics slice, with the JAX package's checks
    with pytest.raises(ValueError, match="Invalid 'stats_chunk_mb' of 0.0"):
        cobrix_tpu_torch.read_cobol(
            str(path), copybook_contents=pgen.EXP1_COPYBOOK, device="cpu",
            cache_dir=str(tmp_path / "cache"), stats_chunk_mb="0")


def _columns(plan, variant_key):
    return [(c.index, c.name, c.offset, c.width, c.codec.name,
             variant_key(c), repr(c.params), c.segment, c.slot_path)
            for c in plan.columns]


EXP3_SEGMENTS = ["STATIC-DETAILS", "CONTACTS"]
PROFILES = [
    ("exp1", jgen.EXP1_COPYBOOK, {}, [None]),
    ("exp3", jgen.EXP3_COPYBOOK, {}, [None]),
    ("exp3-segments", jgen.EXP3_COPYBOOK,
     {"segment_redefines": EXP3_SEGMENTS},
     [None, "STATIC_DETAILS", "CONTACTS"]),
    ("exp2", jgen.EXP2_COPYBOOK, {}, [None]),
    ("transactions", jgen.TRANSDATA_COPYBOOK, {}, [None]),
    ("fillers", jgen.FILLERS_COPYBOOK, {}, [None]),
    ("entity", jgen.ENTITY_FIXED_COPYBOOK, {}, [None]),
    ("hierarchical", jgen.HIERARCHICAL_COPYBOOK, {}, [None]),
]


@pytest.mark.parametrize("name,text,kw,actives", PROFILES,
                         ids=[p[0] for p in PROFILES])
def test_plan_parity(name, text, kw, actives):
    if name.startswith(("exp1", "exp3")):
        assert text == getattr(pgen, name[:4].upper() + "_COPYBOOK")
    jcb, pcb = jax_parse(text, **kw), port_parse(text, **kw)
    assert pcb.record_size == jcb.record_size
    for active in actives:
        jp, pp = jax_compile(jcb, active), port_compile(pcb, active)
        assert pp.record_size == jp.record_size, (name, active)
        assert _columns(pp, port_variant_key) == _columns(
            jp, jax_variant_key), (name, active)


@pytest.mark.parametrize("text", [
    "        01  R.\n          05  A  PIC 9(3)Q.\n",
    "        01  R.\n          05  A  PIC X(2).\n          05  B  PIC S9(4)V9V9 COMP-3.\n",
    "        01  R.\n          05  A  PIC 9(3) OCCURS 2 TIMES DEPENDING ON NOPE.\n",
])
def test_malformed_copybook_raises_the_same_error(text):
    with pytest.raises(Exception) as jerr:
        jax_parse(text)
    with pytest.raises(Exception) as perr:
        port_parse(text)
    assert type(perr.value).__name__ == type(jerr.value).__name__
    assert str(perr.value) == str(jerr.value)
