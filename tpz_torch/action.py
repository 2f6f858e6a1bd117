"""Flush semantics of the streaming encoder: the port's copy of
tpz/action.py, parity with the reference crate's `Action`.

The crate drives its streaming encoders with `Action::{Run, Flush,
Finish}` ([HIGH], SURVEY.md §2.1 "Action" row). The block-oriented design
needs them only at the streaming API boundary
(tpz_torch.api.CodecStream): Run feeds bytes, Flush forces a block
boundary with byte alignment, Finish terminates the stream (final block
and trailer).
"""

from __future__ import annotations

import enum


class Action(enum.Enum):
    RUN = "run"
    FLUSH = "flush"
    FINISH = "finish"
