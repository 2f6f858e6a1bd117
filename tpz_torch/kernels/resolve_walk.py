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
                 Phase 1 resolves segments of `segment_rows * 128`
                 positions, one CUDA block each, in shared memory: every
                 match byte points at its source and pointer jumping
                 follows the chains inside the segment; a source before
                 the segment stays a pointer. Phase 2 follows those
                 pointers in a few rounds over the whole span.
                 `resolve_segments_plain` is its torch twin (the same
                 segments, entries and rounds), which only the tests run.
  doubling       the plain torch version, for CPU tensors: every match
                 byte points at its source, and pointer doubling rounds
                 resolve all positions at once. Its state rides in int64,
                 so no span bound applies (the reference's separate
                 unpacked "wide" doubling is not needed).

`resolve_dense` resolves a span in one call up to its device's span cap:
MAX_PACKED_SPAN on a card (the packed state's bound), the reference's
PHASE2_CAP on the CPU, so the CPU route keeps the reference's structure.
Longer spans are resolved in chunks chained through a halo of
already-resolved output, as in the reference. On valid markers the bytes
are the same either way. On corrupt markers (a stream whose CRC or
length check then fails) the two routes, and the kernel and the plain
version, may give different bytes: matches that overlap other tokens,
zero distances or sources before the span are resolved by each in its
own way.
"""

from __future__ import annotations

import torch

from tpz_torch.kernels._build import SHARED_LIMIT
from tpz_torch.utils.bits import srl32, to_i32

_KIND_LIT = 1
_KIND_MATCH = 2
_LIT0 = _KIND_LIT << 28          # a literal 0 byte: the padding marker

# The reference's chunk bound (one phase-2 pass held the span in TPU
# VMEM), the CPU route's chunk, and the halo, kept as they are: the halo
# must cover the format's LZ window (DEFLATE 32 KiB, lh7 64 KiB).
PHASE2_CAP = 1 << 22
HALO = 1 << 16
MAX_PACKED_SPAN = 1 << 24        # index << 8 must fit in 32 bits
# Phase-1 segment: 64 rows of 128 = 8,192 positions, 64 KiB of shared
# memory (markers and entries, 4 bytes each) a CUDA block.
SEGMENT_ROWS = 64
# Phase 2's rounds: the hops each may take (0: no limit).
PHASE2_HOPS = (64, 64, 0)


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


def _check_segment(segment_rows: int) -> None:
    """Raises unless phase 1's segment (markers and entries, 4 bytes each
    a position) fits one CUDA block's shared memory."""
    need = 8 * 128 * segment_rows
    if segment_rows < 1 or need > SHARED_LIMIT:
        raise ValueError(
            f"copy machine: segment_rows {segment_rows} needs {need} bytes "
            f"of shared memory; a CUDA block holds at most {SHARED_LIMIT}")


def resolve_copy_machine(markers: torch.Tensor, dist_bias: int = 0,
                         segment_rows: int = SEGMENT_ROWS) -> torch.Tensor:
    """[N] int32 dense markers (N % 128 == 0, N <= 2^24) -> [N] int32
    final packed state (u32 bit patterns). CPU tensors take the doubling
    plain version; CUDA tensors launch the copy-machine kernel: phase 1
    over segments of `segment_rows` rows of 128, then phase 2's rounds,
    all on the current stream.

    The host side keeps the reference's structure: boundary carries are
    injected at every segment cut and the tail is padded to whole
    segments with literal markers."""
    if markers.device.type == "cpu":
        return to_i32(resolve_doubling_state(markers, dist_bias))
    if markers.device.type != "cuda":
        raise ValueError(f"copy machine: unsupported device {markers.device}")
    _check(markers)
    _check_segment(segment_rows)
    N = markers.shape[0]
    if N == 0:
        return markers.clone()
    launch = _prepare(markers, dist_bias, segment_rows)
    _launch(*launch)
    resolve_copy_machine.launches += 1
    return launch[1][:N]


resolve_copy_machine.launches = 0
# One launch runs phase 1, then len(PHASE2_HOPS) rounds of phase 2.
resolve_copy_machine.kernels = ("resolve_phase1", "resolve_phase2")


def _segments(markers: torch.Tensor, segment_rows: int) -> tuple:
    """(markers with boundary carries at every segment cut, padded with
    literal markers to whole segments; segment count; segment length) for
    N > 0 markers whose length is a multiple of 128."""
    rows = markers.shape[0] // 128
    sr = min(segment_rows, rows)
    arr = markers if rows <= sr else _inject_boundary_carries(markers,
                                                              sr * 128)
    pad = (-rows) % sr
    if pad:
        arr = torch.cat([arr, torch.full((pad * 128,), _LIT0,
                                         dtype=torch.int32,
                                         device=arr.device)])
    return arr, (rows + pad) // sr, sr * 128


def _prepare(markers: torch.Tensor, dist_bias: int,
             segment_rows: int) -> tuple:
    """The copy machine's launch arguments for N > 0 checked markers:
    (segment-padded markers with boundary carries, state buffer, phase 2's
    pending counts, segment count, segment length, dist_bias)."""
    arr, n_seg, seg_len = _segments(markers, segment_rows)
    pending = torch.zeros(len(PHASE2_HOPS), dtype=torch.int32,
                          device=arr.device)
    return (arr, torch.empty_like(arr), pending, n_seg, seg_len, dist_bias)


def _launch(arr, state, pending, n_seg, seg_len, dist_bias) -> None:
    """One copy-machine launch (phase 1, then phase 2's rounds) on the
    current stream; `pending` must be zero."""
    from tpz_torch.kernels import _build

    with torch.cuda.device(arr.device):
        rc = _build.lib().tpz_resolve_walk(
            arr.data_ptr(), state.data_ptr(), pending.data_ptr(), n_seg,
            seg_len, dist_bias, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"copy machine kernel launch failed: cudaError {rc}")


def _phase1_plain(arr: torch.Tensor, n_seg: int, seg_len: int,
                  dist_bias: int) -> torch.Tensor:
    """Phase 1 of the copy machine in torch, every segment at once:
    [n_seg * seg_len] int32 segment-padded markers -> int64 packed state,
    each position resolved or pointing before its segment."""
    m = arr.reshape(n_seg, seg_len).to(torch.int64) & 0xFFFFFFFF
    loc = torch.arange(seg_len, device=arr.device, dtype=torch.int64)
    base = torch.arange(n_seg, device=arr.device,
                        dtype=torch.int64)[:, None] * seg_len
    kind = m >> 28
    is_start = (kind == _KIND_LIT) | (kind == _KIND_MATCH)
    s = torch.cummax(torch.where(is_start, loc, -1), dim=1).values
    ms = m.gather(1, torch.clamp(s, min=0))
    mlen = ms & 511
    dist = ((ms >> 9) & 0xFFFF) + dist_bias
    k = loc - s
    inside = ((s >= 0) & ((ms >> 28) == _KIND_MATCH) & (dist > 0)
              & (k < mlen))
    src = s - dist + k % torch.clamp(dist, min=1)
    local = inside & (src >= 0)
    out = inside & (src < 0)
    # Pointer jumping over the local pointers: each position ends at the
    # root of its chain inside the segment (resolved, or pointing out).
    ptr = torch.where(local, src, loc)
    while True:
        nxt = ptr.gather(1, ptr)
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    root_out = out.gather(1, ptr)
    target = torch.clamp(base + src, min=0).gather(1, ptr)
    byte = (m & 0xFF).gather(1, ptr)
    gpos = base + loc
    return torch.where(root_out, target << 8, (gpos << 8) | byte).reshape(-1)


def _phase2_round_plain(state: torch.Tensor, hops: int) -> torch.Tensor:
    """One round of phase 2 in torch (synchronous: every chain starts from
    the round's input state): each pointer follows its chain for at most
    `hops` hops (0: until resolved) and keeps what it reached."""
    idx = torch.arange(state.shape[0], device=state.device,
                       dtype=torch.int64)
    cur = state >> 8
    live = cur != idx
    out = state.clone()
    h = 0
    while bool(live.any()) and (hops == 0 or h < hops):
        s = state[cur]
        done = live & ((s >> 8) == cur)
        out = torch.where(done, (idx << 8) | (s & 0xFF), out)
        live = live & ~done
        cur = torch.where(live, s >> 8, cur)
        h += 1
    return torch.where(live, cur << 8, out)


def resolve_segments_plain(markers: torch.Tensor, dist_bias: int = 0,
                           segment_rows: int = SEGMENT_ROWS) -> torch.Tensor:
    """The copy machine's torch twin: [N] int32 markers (N % 128 == 0,
    N > 0) -> [N] int64 final packed state, by the kernel's decomposition:
    the same boundary carries and segments, phase 1 per segment, then
    phase 2's rounds. It runs on any device; nothing on the card path
    calls it."""
    arr, n_seg, seg_len = _segments(markers, segment_rows)
    state = _phase1_plain(arr, n_seg, seg_len, dist_bias)
    for hops in PHASE2_HOPS:
        state = _phase2_round_plain(state, hops)
    return state[:markers.shape[0]]


def span_chunks(device_type: str) -> tuple[int, int]:
    """(the longest span resolve_dense resolves in one call, the chunk
    length of longer spans) on a device type: the packed state's bound on
    a card, whose chunks leave room for the halo; the reference's
    PHASE2_CAP on the CPU."""
    if device_type == "cpu":
        return PHASE2_CAP, PHASE2_CAP
    return MAX_PACKED_SPAN, MAX_PACKED_SPAN - HALO


def resolve_dense(markers: torch.Tensor, dist_bias: int = 0) -> torch.Tensor:
    """Flat [N] int32 dense markers (N % 128 == 0) -> [N] uint8 plaintext.
    A span up to the device's cap (span_chunks) resolves in one
    copy-machine call. Longer spans resolve chunk by chunk; each later
    chunk is preceded by the previous chunk's last HALO bytes as literal
    markers, so its backward copies land in range (HALO >= the LZ
    window)."""
    N = markers.shape[0]
    cap, step = span_chunks(markers.device.type)
    if N <= cap:
        st = resolve_copy_machine(markers, dist_bias)
        return (st & 0xFF).to(torch.uint8)
    # A match crossing a chunk cut restarts there as a carry; its dist is
    # within the window, so the restarted copy reads the halo.
    markers = _inject_boundary_carries(markers, step)
    outs = []
    tail = None
    for lo in range(0, N, step):
        part = markers[lo:lo + step]
        n = part.shape[0]
        ext = part if tail is None else torch.cat([tail, part])
        st = resolve_copy_machine(ext, dist_bias)
        st = st[ext.shape[0] - n:]
        out = (st & 0xFF).to(torch.uint8)
        outs.append(out)
        tail = _LIT0 | out[n - HALO:].to(torch.int32)
    return torch.cat(outs)
