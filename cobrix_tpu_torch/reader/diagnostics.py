"""Structured framing errors.

Port copy of ``cobrix_tpu.reader.diagnostics``, reduced to `hex_snapshot`
and `FramingError`, plus `framing_error`, the copy of
``cobrix_tpu.native._framing_error``: a malformed RDW header raises the
same exception class, message, offset and reason as the JAX package. The
port reads under the fail-fast policy only, so the error ledger, the
corrupt-record entries and the error policies are not carried over.
"""
from __future__ import annotations


def hex_snapshot(header, limit: int = 16) -> str:
    """Hex dump of a header/byte prefix for error messages
    ('00 00 0a 00'); empty input renders as '<empty>'."""
    data = bytes(header[:limit])
    if not data:
        return "<empty>"
    out = " ".join(f"{b:02x}" for b in data)
    return out + (" .." if len(header) > limit else "")


class FramingError(ValueError):
    """A malformed record header/length with structured location info.

    Subclasses ValueError, as the JAX package's does, so fail-fast callers
    that catch ValueError keep working.
    """

    def __init__(self, message: str, offset: int = -1, reason: str = "",
                 header: bytes = b""):
        super().__init__(message)
        self.offset = offset
        self.reason = reason or message
        self.header = bytes(header)


def framing_error(header: bytes, pos: int, kind: str) -> FramingError:
    """The FramingError of a zero (`kind` "zero") or oversized ("big")
    RDW header: `header` holds the header's bytes, `pos` its file offset.
    Messages keep the reference wording plus a hex header snapshot."""
    header = bytes(header[:4])
    hdr = ",".join(str(b) for b in header)
    if kind == "zero":
        message = (f"RDW headers should never be zero ({hdr}). "
                   f"Found zero size record at {pos} "
                   f"(header bytes: {hex_snapshot(header)}).")
        reason = "zero-length RDW header"
    else:
        message = (f"RDW headers too big at {pos} "
                   f"(header bytes: {hex_snapshot(header)}).")
        reason = "oversized RDW header"
    return FramingError(message, offset=int(pos), reason=reason,
                        header=header)
