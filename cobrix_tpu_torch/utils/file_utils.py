"""File-scanning helpers.

Port copy of ``cobrix_tpu.utils.file_utils``: equivalents of the
reference's `FileUtils` (spark-cobol utils/FileUtils.scala:54-228):
recursive globbed listing skipping hidden files (`list_input_files`, the
one copy, which ``api.read_cobol`` uses; the JAX package keeps it in its
API layer) and the non-divisible-file scan
used to validate fixed-length inputs before launching a read
(FileUtils.findAndLogAllNonDivisibleFiles, used by
CobolScanners.scala:88).
"""
from __future__ import annotations

import glob as _glob
import os
from typing import List, Tuple

from ..reader.stream import (normalize_local, path_scheme, source_size,
                             stream_lister)


def list_input_files(path) -> List[str]:
    """Files under `path` (a file, directory or glob, or a list of them),
    recursively, skipping hidden names, in a stable order (reference
    FileUtils.scala:54-228, getListFilesWithOrder). ``file://`` and plain
    paths are local; another scheme's directories and globs are listed
    by its backend's lister (`stream_lister`: the fsspec adapter, or one
    registered with ``lister=``), and a scheme without one passes
    through verbatim as one input."""
    paths = [path] if isinstance(path, str) else list(path)
    out: List[str] = []
    for p in paths:
        scheme = path_scheme(p)
        if scheme not in (None, "file"):
            lister = stream_lister(scheme)
            if lister is not None:
                out.extend(lister(p))
            else:
                out.append(p)
            continue
        # file:// never propagates past listing: downstream os.path
        # consumers see plain local paths
        p = normalize_local(p)
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if not d.startswith((".", "_")))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith((".", "_")))
        elif os.path.isfile(p):
            out.append(p)
        else:
            matched = sorted(_glob.glob(p))
            if not matched:
                raise FileNotFoundError(f"Input path does not exist: {p}")
            for m in matched:
                out.extend(list_input_files(m))
    return out


def find_non_divisible_files(path, divisor: int) -> List[Tuple[str, int]]:
    """(file, size) for every input file whose byte size is not a multiple
    of `divisor` (the record size). Empty list means the fixed-length read
    is safe. Sizes resolve through the storage backend for `scheme://`
    inputs, so remote directories validate exactly like local ones."""
    if divisor < 1:
        raise ValueError(f"Invalid divisor {divisor}")
    out: List[Tuple[str, int]] = []
    for f in list_input_files(path):
        size = source_size(f)
        if size % divisor != 0:
            out.append((f, size))
    return out


def get_number_of_files(path) -> int:
    return len(list_input_files(path))


def total_size(path) -> int:
    return sum(source_size(f) for f in list_input_files(path))
