"""Crash-safe file writes: temp file + rename for whole artifacts, and
single-syscall O_APPEND appends for record logs — shared by every plane
that persists something (trace export, roofline calibration, block
cache, index store, scan audit log).

The guarantee: a reader never observes a partially-written file under
the final name — it sees the previous complete content or nothing. With
``fsync=True`` the guarantee extends across power loss / process kill on
filesystems that would otherwise surface a zero-length file under the
FINAL name after a crash shortly following the rename (durability
before visibility). Cache planes that can cheaply rebuild a lost entry
skip the fsync; artifacts a human or gate reads (traces, calibrations)
take it.

This module must stay import-light (no package-internal imports): it is
used from ``obs/`` which ``api`` itself imports.

Port copy of ``cobrix_tpu.utils.atomic``, unchanged.
"""
from __future__ import annotations

import os
import tempfile
from typing import Union


def append_line(path: str, line: str) -> int:
    """Append one newline-terminated record to `path` as a SINGLE
    O_APPEND write (creating the file 0666&~umask if absent). POSIX
    O_APPEND makes the offset seek+write atomic per call, so concurrent
    appenders (threads or processes sharing an audit log) interleave
    whole records, never splice bytes mid-record. Returns the bytes
    written so callers can track size for rotation without a stat."""
    if not line.endswith("\n"):
        line += "\n"
    data = line.encode("utf-8")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return len(data)


def write_atomic(path: str, data: Union[bytes, str],
                 fsync: bool = False) -> None:
    """Write `data` to `path` atomically (temp + rename in the target
    directory). On any failure the temp file is removed and the error
    re-raised; the target is either untouched or fully replaced."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    text = isinstance(data, str)
    fd, tmp = tempfile.mkstemp(dir=parent, prefix=".tmp-")
    try:
        # mkstemp creates 0600; artifacts written through here are read
        # by watchers/other processes (traces, shared cache dirs), so
        # restore the umask-derived mode a plain open() would have used
        um = os.umask(0)
        os.umask(um)
        os.chmod(tmp, 0o666 & ~um)
        with os.fdopen(fd, "w" if text else "wb",
                       encoding="utf-8" if text else None) as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
