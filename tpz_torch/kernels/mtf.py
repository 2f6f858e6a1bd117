"""Move-to-front encode (port of tpz/kernels/mtf.py `mtf_ranks`).

The MTF rank of symbol s at position i is the number of symbols whose
last occurrence before i is more recent than s's:

    rank_i = #{ t : key_t(i) > key_s(i) },
    key_t(i) = last occurrence of t in [0, i), or -1 - t if unseen
               (unseen symbols keep their initial order).

`mtf_ranks_plain` is the reference's chunked form of that formula: per
chunk of CHUNK positions, a cummax over a [chunk, alpha] expansion gives
the last occurrences. `mtf_ranks` is the wrapper: the plain version for
CPU tensors, the CUDA kernel csrc/mtf_encode.cu (one warp per row walking
the list itself) for CUDA tensors.

Both return 0 at positions at or past a row's length, where the
reference's output is unspecified.
"""

from __future__ import annotations

import torch

CHUNK = 2048
NEG = -300


def mtf_ranks_plain(v: torch.Tensor, length: torch.Tensor,
                    alpha: int = 256) -> torch.Tensor:
    """v [NB, n] int32 symbols (< alpha); length [NB] int32. Returns
    [NB, n] int32 MTF ranks."""
    NB, n = v.shape
    dev = v.device
    pad = (-n) % CHUNK
    vc = torch.nn.functional.pad(v, (0, pad)).reshape(NB, -1, CHUNK)
    sym = torch.arange(alpha, device=dev, dtype=torch.int32)
    pos = torch.arange(CHUNK, device=dev, dtype=torch.int32)[None, :, None]
    carry = -1 - sym.expand(NB, alpha)
    lead = torch.full((NB, 1, alpha), NEG, dtype=torch.int32, device=dev)
    # Chunks past every row's length hold only zeroed outputs.
    live_chunks = min(-(-int(length.max()) // CHUNK) if NB else 0,
                      vc.shape[1])
    out = []
    for c in range(live_chunks):
        xc = vc[:, c]
        onehot_pos = torch.where(xc[:, :, None] == sym, c * CHUNK + pos, NEG)
        cmax_incl = torch.cummax(onehot_pos, dim=1).values
        cmax_excl = torch.cat([lead, cmax_incl[:, :-1]], dim=1)
        keys = torch.maximum(carry[:, None, :], cmax_excl)
        own = torch.gather(keys, 2, xc[:, :, None].to(torch.int64))
        out.append((keys > own).sum(dim=2, dtype=torch.int32))
        carry = torch.maximum(carry, cmax_incl[:, -1])
    out.append(torch.zeros((NB, CHUNK * (vc.shape[1] - live_chunks)),
                           dtype=torch.int32, device=dev))
    ranks = torch.cat(out, dim=1)[:, :n]
    live = torch.arange(n, device=dev)[None, :] < length[:, None]
    return torch.where(live, ranks, 0)


def mtf_ranks(v: torch.Tensor, length: torch.Tensor,
              alpha: int = 256) -> torch.Tensor:
    """MTF ranks of v [NB, n] int32 (< alpha <= 256) over each row's
    first length [NB] int32 positions: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (both contiguous int32)."""
    if v.device.type == "cpu":
        return mtf_ranks_plain(v, length, alpha)
    if v.device.type != "cuda":
        raise ValueError(f"mtf encode: unsupported device {v.device}")
    if not 1 <= alpha <= 256:
        raise ValueError(f"mtf encode: alpha {alpha} outside 1..256")
    NB, n = v.shape
    for name, t, shape in (("v", v, (NB, n)), ("length", length, (NB,))):
        if (t.device != v.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"mtf encode: {name} must be a contiguous int32 tensor of "
                f"shape {shape} on {v.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    out = torch.zeros((NB, n), dtype=torch.int32, device=v.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(v.device):
        rc = _build.lib().tpz_mtf_encode(
            v.data_ptr(), length.data_ptr(), out.data_ptr(), NB, n,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mtf encode kernel launch failed: cudaError {rc}")
    mtf_ranks.launches += 1
    return out


mtf_ranks.launches = 0
