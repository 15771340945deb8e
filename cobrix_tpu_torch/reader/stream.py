"""Input paths.

Port copy of the path helpers of ``cobrix_tpu.reader.stream``:
`path_scheme` and `normalize_local`, as they were. The port reads local
files only, so the stream classes, the retry policy and the registry of
storage backends (``scheme://`` paths) are not carried over
(ROADMAP A4f); ``api.list_input_files`` refuses any scheme but
``file://`` by name.
"""
from __future__ import annotations

from typing import Optional


def path_scheme(path: str) -> Optional[str]:
    """'s3://bucket/key' -> 's3'; None for plain local paths (a Windows
    drive letter is not a scheme)."""
    head, sep, _ = path.partition("://")
    if not sep or len(head) <= 1:
        return None
    return head.lower()


def normalize_local(path: str) -> str:
    """Strip the `file://` prefix so every os.path consumer downstream
    sees a plain local path; other paths pass through unchanged."""
    if path_scheme(path) == "file":
        return path[len("file://"):]
    return path
