"""LZ77 match resolution over the dense marker space (port of
tpz/kernels/resolve_walk.py and of the pointer-doubling resolve in
tpz/kernels/inflate_pipeline.py).

Markers (the symbol walk's output, one per output byte): `1 << 28 | byte`
for a literal, `2 << 28 | dist << 9 | len` at a match's first byte, 0 on
the match's other bytes. Resolution turns them into packed state,
`index << 8 | byte` once a position is final ("resolved" means
`state >> 8 == own index`), `target << 8` while it still points at
another position; the plaintext is `state & 0xFF`.

Two resolvers with the same final state on valid markers:
  copy machine   the CUDA kernel (csrc/resolve_walk.cu), for CUDA tensors.
                 Phase 1 walks segments of `segment_rows * 128` positions
                 in order, in parallel across segments; copies that reach
                 before their segment become pointers. Phase 2 follows
                 those pointers (they always lead to an earlier segment).
  doubling       the plain torch version, for CPU tensors: every match
                 byte points at its source, and pointer doubling rounds
                 resolve all positions at once. Its state rides in int64,
                 so no span bound applies (the reference's separate
                 unpacked "wide" doubling is not needed).
Spans above PHASE2_CAP are resolved in chunks chained through a halo of
already-resolved output (`resolve_dense`), as in the reference.
"""

from __future__ import annotations

import torch

from tpz_torch.utils.bits import srl32, to_i32

_KIND_LIT = 1
_KIND_MATCH = 2
_LIT0 = _KIND_LIT << 28          # a literal 0 byte: the padding marker

# The reference's chunk bound (one phase-2 pass held the span in TPU
# VMEM) and its halo, kept as they are: the halo must cover the format's
# LZ window (DEFLATE 32 KiB, lh7 64 KiB).
PHASE2_CAP = 1 << 22
HALO = 1 << 16
SEGMENT_ROWS = 512               # phase-1 segment: 512 rows of 128
MAX_PACKED_SPAN = 1 << 24        # index << 8 must fit in 32 bits


def _token_start(markers: torch.Tensor) -> torch.Tensor:
    """Per position: the latest token start at or before it, as its index
    when that token is a match, as -index - 1 when it is a literal, and
    -2^30 when no token precedes."""
    gpos = torch.arange(markers.shape[0], device=markers.device,
                        dtype=torch.int64)
    kind = srl32(markers, 28)
    is_start = kind == _KIND_MATCH
    tok = torch.where(is_start | (kind == _KIND_LIT),
                      torch.where(is_start, gpos, -gpos - 1),
                      torch.full_like(gpos, -(1 << 30)))
    return torch.cummax(tok, dim=0).values


def _inject_boundary_carries(markers: torch.Tensor,
                             step: int) -> torch.Tensor:
    """At every `step`-multiple boundary that a match spans, write a
    continuation marker (same dist, the remaining len) at the boundary
    position, so a walk that starts there never needs the marker from
    before it. Matches are at most 511 long: one marker per boundary
    suffices, and only a match that starts in the 511 positions before a
    boundary can span it. So where the reference takes a cummax over the
    whole span, this takes the latest match start in each boundary's
    512-position window, which gives the same markers and spares the
    one-row scan that took most of the resolve's device time on an
    H100. Returns a new tensor."""
    N = markers.shape[0]
    if step >= N:
        return markers
    bpos = torch.arange(step, N, step, device=markers.device)
    win = bpos[:, None] + torch.arange(-511, 1, device=markers.device)
    wm = markers[torch.clamp(win, min=0)]
    is_start = (srl32(wm, 28) == _KIND_MATCH) & (win >= 0)
    s = torch.where(is_start, win, -1).amax(dim=1)
    sm = markers[torch.clamp(s, min=0)].to(torch.int64)
    mlen = sm & 511
    covers = (s >= 0) & (s < bpos) & (s + mlen > bpos)
    inj = (_KIND_MATCH << 28) | (sm & (0xFFFF << 9)) | (s + mlen - bpos)
    out = markers.clone()
    out[bpos] = torch.where(covers, inj.to(torch.int32), markers[bpos])
    return out


def resolve_doubling_state(markers: torch.Tensor,
                           dist_bias: int = 0) -> torch.Tensor:
    """The plain version: [N] int32 markers -> [N] int64 final packed
    state, by pointer doubling (tpz/kernels/inflate_pipeline.py
    _resolve_doubling). A self-overlapping match (dist < len) reads
    `start - dist + (k mod dist)` for its byte k, which always lies before
    the match, so chains stay as deep as the token chain."""
    N = markers.shape[0]
    gpos = torch.arange(N, device=markers.device, dtype=torch.int64)
    m = markers.to(torch.int64) & 0xFFFFFFFF
    seg = _token_start(markers)
    in_match = seg >= 0
    start = torch.clamp(seg, min=0)
    smark = m[start]
    mlen = smark & 511
    # dist_bias: LZHUF markers store dist - 1.
    mdist = ((smark >> 9) & 0xFFFF) + dist_bias
    inside = in_match & (gpos < start + mlen)
    k = gpos - start
    d = torch.clamp(mdist, min=1)
    src = start - mdist + k % d
    # Corrupt streams can point before the span; the clamp keeps every
    # gather in range (the CRC rejects the bytes).
    ptr = torch.clamp(torch.where(inside, src, gpos), 0, N - 1)
    val = torch.where(inside, 0, m & 0xFF)
    state = (ptr << 8) | val
    self_hi = gpos << 8

    def full_round(s):
        g = s[s >> 8]
        return torch.where((g >> 8) == (s >> 8), self_hi | (g & 0xFF),
                           g & ~0xFF)

    state = full_round(full_round(state))
    while not bool(((state & ~0xFF) == self_hi).all()):
        state = full_round(state)
    return state


def _check(markers: torch.Tensor) -> None:
    if (markers.dtype != torch.int32 or markers.dim() != 1
            or not markers.is_contiguous() or markers.shape[0] % 128
            or markers.shape[0] > MAX_PACKED_SPAN):
        raise ValueError(
            "copy machine: markers must be a contiguous 1-D int32 tensor "
            f"whose length is a multiple of 128 and at most "
            f"{MAX_PACKED_SPAN}, got {markers.dtype} {tuple(markers.shape)}")


def resolve_copy_machine(markers: torch.Tensor, dist_bias: int = 0,
                         segment_rows: int = SEGMENT_ROWS) -> torch.Tensor:
    """[N] int32 dense markers (N % 128 == 0, N <= 2^24) -> [N] int32
    final packed state (u32 bit patterns). CPU tensors take the doubling
    plain version; CUDA tensors launch the copy-machine kernel.

    The host side keeps the reference's structure: one segment resolves in
    phase 1 alone; otherwise boundary carries are injected at every
    segment cut, the tail is padded to whole segments with literal
    markers, and phase 2 follows."""
    if markers.device.type == "cpu":
        return to_i32(resolve_doubling_state(markers, dist_bias))
    if markers.device.type != "cuda":
        raise ValueError(f"copy machine: unsupported device {markers.device}")
    _check(markers)
    if segment_rows < 1:
        raise ValueError(f"copy machine: segment_rows {segment_rows} < 1")
    N = markers.shape[0]
    if N == 0:
        return markers.clone()
    launch = _prepare(markers, dist_bias, segment_rows)
    _launch(*launch)
    resolve_copy_machine.launches += 1
    return launch[1][:N]


resolve_copy_machine.launches = 0


def _prepare(markers: torch.Tensor, dist_bias: int,
             segment_rows: int) -> tuple:
    """The copy machine's launch arguments for N > 0 checked markers:
    (segment-padded markers with boundary carries, state buffer, segment
    count, segment length, dist_bias, two_phase)."""
    rows = markers.shape[0] // 128
    sr = min(segment_rows, rows)
    single = rows <= sr
    arr = markers if single else _inject_boundary_carries(markers, sr * 128)
    pad = (-rows) % sr
    if pad:
        arr = torch.cat([arr, torch.full((pad * 128,), _LIT0,
                                         dtype=torch.int32,
                                         device=arr.device)])
    return (arr, torch.empty_like(arr), (rows + pad) // sr, sr * 128,
            dist_bias, int(not single))


def _launch(arr, state, n_seg, seg_len, dist_bias, two_phase) -> None:
    """One copy-machine launch (both phases) on the current stream."""
    from tpz_torch.kernels import _build

    with torch.cuda.device(arr.device):
        rc = _build.lib().tpz_resolve_walk(
            arr.data_ptr(), state.data_ptr(), n_seg, seg_len, dist_bias,
            two_phase, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"copy machine kernel launch failed: cudaError {rc}")


def resolve_dense(markers: torch.Tensor, dist_bias: int = 0) -> torch.Tensor:
    """Flat [N] int32 dense markers (N % 128 == 0) -> [N] uint8 plaintext.
    Spans past PHASE2_CAP resolve chunk by chunk; each later chunk is
    preceded by the previous chunk's last HALO bytes as literal markers,
    so its backward copies land in range (HALO >= the LZ window)."""
    N = markers.shape[0]
    if N <= PHASE2_CAP:
        st = resolve_copy_machine(markers, dist_bias)
        return (st & 0xFF).to(torch.uint8)
    # A match crossing a chunk cut restarts there as a carry; its dist is
    # within the window, so the restarted copy reads the halo.
    markers = _inject_boundary_carries(markers, PHASE2_CAP)
    outs = []
    tail = None
    for lo in range(0, N, PHASE2_CAP):
        part = markers[lo:lo + PHASE2_CAP]
        n = part.shape[0]
        ext = part if tail is None else torch.cat([tail, part])
        st = resolve_copy_machine(ext, dist_bias)
        st = st[ext.shape[0] - n:]
        out = (st & 0xFF).to(torch.uint8)
        outs.append(out)
        tail = _LIT0 | out[n - HALO:].to(torch.int32)
    return torch.cat(outs)
