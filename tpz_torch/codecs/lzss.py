"""Raw LZSS codec (port of tpz/codecs/lzss.py).

The token stream is the oracle's (`oracle.lzss_tokenize`), serialised as
a tagged-byte stream: a flag byte for every 8 codes (bit i set: code i is
a reference), a literal as its byte, a reference as 3 bytes, len -
min_match then the distance as <H. The container puts the original size
in front as 8 little-endian bytes.

It runs on the host, as the reference does: the codec has no device
stage. `device` is validated as at every entry point (a CUDA device
without a card raises) and names no work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpz_torch import oracle
from tpz_torch.errors import UnexpectedEof
from tpz_torch.kernels.deflate_pipeline import _device


@dataclass(frozen=True)
class LzssConfig:
    """The encoder's parameters (the reference crate's LzssEncoder::new)."""
    window: int = 32768
    min_match: int = 3
    max_match: int = 258
    max_chain: int = 16
    lazy: bool = False
    block_size: int = 65536

    def params_array(self):
        return oracle.params_array(
            window=self.window, min_match=self.min_match,
            max_match=self.max_match, max_chain=self.max_chain,
            lazy=self.lazy, block_size=self.block_size,
            too_far_rule=False)


def tokenize(data: bytes, config: LzssConfig | None = None) -> np.ndarray:
    """[N, 4] int32 (pos, len, lit, dist); len == 0 is a literal, else a
    reference of len bytes dist back."""
    cfg = config or LzssConfig()
    return oracle.lzss_tokenize(data, cfg.params_array())


def compress(data: bytes, level: int = 6, *, device="cuda",
             config: LzssConfig | None = None) -> bytes:
    """`level` is taken for the api's sake and ignored, as the
    reference's is."""
    _device(device)
    cfg = config or LzssConfig()
    body = oracle.lzss_pack(tokenize(data, cfg), cfg.min_match)
    return len(data).to_bytes(8, "little") + body


def decompress(data: bytes, *, device="cuda",
               config: LzssConfig | None = None) -> bytes:
    _device(device)
    cfg = config or LzssConfig()
    if len(data) < 8:
        raise UnexpectedEof("lzss stream too short")
    n = int.from_bytes(data[:8], "little")
    return oracle.lzss_unpack(data[8:], n, cfg.min_match)
