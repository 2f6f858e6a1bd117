"""Move-to-front encode (port of tpz/kernels/mtf.py `mtf_ranks`).

The MTF rank of symbol s at position i is the number of symbols whose
last occurrence before i is more recent than s's:

    rank_i = #{ t : key_t(i) > key_s(i) },
    key_t(i) = last occurrence of t in [0, i), or -1 - t if unseen
               (unseen symbols keep their initial order).

`mtf_ranks_plain` is the reference's chunked form of that formula: per
chunk of CHUNK positions, a cummax over a [chunk, alpha] expansion gives
the last occurrences. `mtf_ranks` is the wrapper: the plain version for
CPU tensors, the CUDA kernels of csrc/mtf_encode.cu for CUDA tensors. They
cut each row into segments of MTF_SEG symbols and use the formula to
start every segment's list walk at once:

  E1 last   the last occurrence of each symbol inside each segment
  E2 keys   per row, an exclusive max-scan of those over the segments:
            the keys entering each segment
  E3 walk   per segment, the list ordered by those keys (the symbol with
            the largest key first), then the list walk itself

`mtf_ranks_segments_plain` is the torch twin of those three passes, which
the tests hold equal to the plain version and to the reference.

All return 0 at positions at or past a row's length, where the
reference's output is unspecified.
"""

from __future__ import annotations

import torch

CHUNK = 2048
NEG = -300
# Symbols a segment of the CUDA kernels (mtf_ranks).
MTF_SEG = 4096


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


def mtf_ranks_segments_plain(v: torch.Tensor, length: torch.Tensor,
                             alpha: int = 256,
                             seg: int = MTF_SEG) -> torch.Tensor:
    """The torch twin of the CUDA passes E1-E3 at segments of `seg`
    symbols: arguments and result as mtf_ranks_plain."""
    NB, n = v.shape
    dev = v.device
    nseg = -(-n // seg)
    if nseg == 0:
        return torch.zeros_like(v)
    pos = torch.arange(nseg * seg, device=dev)
    live = pos[None, :] < length.to(torch.int64)[:, None]
    vp = torch.nn.functional.pad(v.to(torch.int64), (0, nseg * seg - n))
    vp = torch.where(live, vp, 0)
    # E1: the last occurrence of each symbol inside each segment, or -1.
    idx = torch.where(live, (pos // seg) * 256 + vp, nseg * 256)
    last = torch.full((NB, nseg * 256 + 1), -1, dtype=torch.int64,
                      device=dev)
    last.scatter_reduce_(1, idx, pos.expand(NB, -1), "amax")
    last = last[:, :-1].reshape(NB, nseg, 256)
    # E2: the keys entering each segment, -1 - t for a symbol unseen.
    key = -1 - torch.arange(256, device=dev).expand(NB, 256)
    keys = []
    for k in range(nseg):
        keys.append(key)
        key = torch.where(last[:, k] >= 0, last[:, k], key)
    keys = torch.stack(keys, dim=1).reshape(NB * nseg, 256)
    # E3: the list ordered by key, largest first (the keys are distinct,
    # so the rank of t is the number of keys above its key), then the walk.
    lst = torch.argsort(keys, dim=1, descending=True)
    lane = torch.arange(256, device=dev)
    syms = vp.reshape(NB * nseg, seg)
    out = torch.zeros_like(syms)
    for i in range(min(seg, n)):
        s = syms[:, i:i + 1]
        j = (lst == s).to(torch.int32).argmax(dim=1, keepdim=True)
        moved = torch.where(lane == 0, s, torch.roll(lst, 1, 1))
        lst = torch.where(lane <= j, moved, lst)
        out[:, i] = j[:, 0]
    out = out.reshape(NB, nseg * seg)
    return torch.where(live, out, 0)[:, :n].to(torch.int32)


def mtf_ranks(v: torch.Tensor, length: torch.Tensor, alpha: int = 256,
              seg: int = MTF_SEG) -> torch.Tensor:
    """MTF ranks of v [NB, n] int32 (< alpha <= 256) over each row's
    first length [NB] int32 positions: the plain version for CPU tensors,
    the CUDA kernels at segments of `seg` symbols for CUDA tensors (both
    contiguous int32)."""
    if v.device.type == "cpu":
        return mtf_ranks_plain(v, length, alpha)
    if v.device.type != "cuda":
        raise ValueError(f"mtf encode: unsupported device {v.device}")
    if not 1 <= alpha <= 256:
        raise ValueError(f"mtf encode: alpha {alpha} outside 1..256")
    NB, n = v.shape
    if seg < 1 or NB > 65535:
        raise ValueError(f"mtf encode: segments of {seg} symbols, {NB} "
                         "rows; need >= 1 and <= 65535")
    for name, t, shape in (("v", v, (NB, n)), ("length", length, (NB,))):
        if (t.device != v.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"mtf encode: {name} must be a contiguous int32 tensor of "
                f"shape {shape} on {v.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    out = torch.zeros((NB, n), dtype=torch.int32, device=v.device)
    keys = torch.empty((NB, -(-n // seg), 256), dtype=torch.int32,
                       device=v.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(v.device):
        for p, kernel in enumerate(mtf_ranks.kernels):
            rc = _build.lib().tpz_mtf_encode(
                v.data_ptr(), length.data_ptr(), out.data_ptr(),
                keys.data_ptr(), NB, n, seg, p,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"mtf encode: {kernel} launch failed: "
                                   f"cudaError {rc}")
    mtf_ranks.launches += 1
    return out


mtf_ranks.launches = 0
# The CUDA kernels of one call, in launch order (pass 0-2 of the C entry).
mtf_ranks.kernels = ("mtf_last_kernel", "mtf_keys_kernel",
                     "mtf_encode_kernel")
