"""Error surface of the port — its copy of tpz/errors.py, parity with the
reference crate's CompressionError.

The rust-compression crate exposes a single error enum `CompressionError`
with variants {DataError, UnexpectedEof, Unexpected} ([MED], SURVEY.md §0.1
Q7 / §2.1 "Errors" row; mount empty so no file:line cite). We mirror it as
an exception hierarchy so `except CompressionError` catches everything, and
the specific variants remain distinguishable.
"""

from __future__ import annotations


class CompressionError(Exception):
    """Base class for all codec errors (parity: CompressionError)."""


class DataError(CompressionError):
    """Malformed or corrupt compressed data (parity: DataError)."""


class UnexpectedEof(CompressionError):
    """Input ended before the stream was complete (parity: UnexpectedEof)."""


class Unexpected(CompressionError):
    """Internal invariant violation (parity: Unexpected)."""


# C ABI status codes shared with the C++ oracle (cpp/common.h mirrors these).
STATUS_OK = 0
STATUS_DATA_ERROR = 1
STATUS_UNEXPECTED_EOF = 2
STATUS_UNEXPECTED = 3
STATUS_BUFFER_TOO_SMALL = 4

_STATUS_TO_EXC = {
    STATUS_DATA_ERROR: DataError,
    STATUS_UNEXPECTED_EOF: UnexpectedEof,
    STATUS_UNEXPECTED: Unexpected,
}


def raise_for_status(status: int, context: str = "") -> None:
    """Raise the Python exception matching a C-oracle status code."""
    if status == STATUS_OK:
        return
    exc = _STATUS_TO_EXC.get(status, Unexpected)
    raise exc(context or f"oracle status {status}")
