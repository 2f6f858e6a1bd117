"""Raw DEFLATE codec (RFC 1951) on a torch device: level profiles, the
encode entry points and the decode entry points (port of
tpz/codecs/deflate.py).

There is no "auto" and no silent fallback: `device` names where the work
runs, and a CUDA device without a card raises. Decode takes the segmented
route (kernels/inflate_pipeline.py), which needs no side-car; a stream
the segment indexer declines goes to the host inflate and is counted in
inflate_pipeline.host_declines.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpz_torch import errors, oracle
from tpz_torch.kernels import deflate_pipeline, inflate_pipeline
from tpz_torch.utils.profiling import _nohook


@dataclass(frozen=True)
class DeflateConfig:
    """Level profiles (parse spec v3, cpp/lzss.h): suffix-space candidates
    with top-2 saturated extension. A copy of tpz.codecs.deflate's, which
    cannot be imported without jax."""

    level: int = 6
    window: int = 32768
    block_size: int = 65536

    @property
    def max_chain(self) -> int:
        """Suffix neighbors scanned per direction (R)."""
        return 4 if self.level <= 3 else (8 if self.level <= 6 else 32)

    @property
    def lazy(self) -> bool:
        return self.level >= 4

    @property
    def screen_bytes(self) -> int:
        return 32 if self.level >= 7 else 16

    @property
    def max_lazy(self) -> int:
        return 258

    @property
    def n_extend(self) -> int:
        """Saturated candidates extended per token."""
        return 2

    @property
    def suffix_mode(self) -> bool:
        return True

    @property
    def restart(self) -> int:
        """Parse-restart interval (cpp/lzss.h LzssParams.restart): the
        sub-walk length that makes block_size / restart independent parse
        walks per block."""
        return 16384

    def params_array(self):
        return oracle.params_array(
            window=self.window,
            max_chain=self.max_chain,
            block_size=self.block_size,
            lazy=self.lazy,
            max_lazy=self.max_lazy,
            n_extend=self.n_extend,
            screen_bytes=self.screen_bytes,
            suffix_mode=self.suffix_mode,
            restart=self.restart,
        )


def compress(data: bytes, level: int = 6, *, device="cuda",
             config: DeflateConfig | None = None) -> bytes:
    cfg = config or DeflateConfig(level=level)
    return deflate_pipeline.compress(data, cfg, device)


def compress_indexed(data: bytes, level: int = 6, *, device="cuda",
                     config: DeflateConfig | None = None):
    """Encode + block index: (stream, block_end_bits, block_out_lens)."""
    cfg = config or DeflateConfig(level=level)
    return deflate_pipeline.compress_indexed(data, cfg, device)


def compress_many(datas, level: int = 6, *, device="cuda",
                  config: DeflateConfig | None = None) -> list[bytes]:
    """Batch encode: one device invocation for many independent streams."""
    cfg = config or DeflateConfig(level=level)
    return deflate_pipeline.compress_many(list(datas), cfg, device)


def compress_flush(data: bytes, level: int = 6,
                   config: DeflateConfig | None = None) -> bytes:
    """An Action::Flush segment: no BFINAL anywhere, then a sync-flush
    empty stored block. Segments from this, then one `compress` segment,
    concatenate into one valid stream. The oracle encodes it, as in the
    reference (its parse equals the device encoder's)."""
    cfg = config or DeflateConfig(level=level)
    return oracle.deflate_encode_flush(data, cfg.params_array())


def decompress(data: bytes, *, device="cuda") -> bytes:
    plain, consumed = decompress_prefix(data, device=device)
    if consumed != len(data):
        raise errors.DataError(f"trailing garbage after deflate stream "
                               f"({len(data) - consumed} bytes)")
    return plain


def decompress_prefix(data: bytes, *, device="cuda",
                      stage_hook=_nohook) -> tuple[bytes, int]:
    """Decode a raw DEFLATE stream that may be followed by more data (a
    container trailer). Returns (plaintext, consumed bytes)."""
    device = deflate_pipeline._device(device)
    idx = inflate_pipeline.index_stream(data)
    if idx is None:
        return inflate_pipeline._host_inflate(data)
    return (inflate_pipeline.decompress_segmented(data, idx, device,
                                                  stage_hook=stage_hook),
            idx["consumed"])
