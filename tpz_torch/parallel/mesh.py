"""Device mesh, sharded encode step and sharded gzip and bzip2 encodes
(port of tpz/parallel/mesh.py).

The reference is a single controller over N JAX devices: a `Mesh` with
one axis, and `shard_map` bodies whose collectives (`all_gather`,
`ppermute`) move data between devices. Here a `Mesh` is an axis name and
one `torch.device` per shard, in one process. A function on the mesh
runs its per-shard body once per shard, one shard after another, and its
collectives between those bodies; a collective moves each shard's
tensors to the shards that receive them with `.to(device)`. So shards
that share a card (all of them, on a machine with one card) run one
after another on it, and sharding there buys no speed: it keeps the
reference's cut into independent members and streams.

Data-parallel over independent DEFLATE blocks and bzip2 blocks: a gzip
member per shard (the window resets at the cut), a bzip2 stream per
block; the halo'd encode step passes each shard's last 32 KiB window to
the next shard with `ppermute`, and the gathers are ordered.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import torch

from tpz_torch import oracle
from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.utils.profiling import _nohook

FWD = 512  # forward pad of the encode step's rows


@dataclass(frozen=True)
class Mesh:
    """One axis of shards: shard i runs on devices[i]."""
    devices: tuple
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device="cuda") -> Mesh:
    """A mesh of `n_devices` shards (the reference's make_mesh,
    tpz/parallel/mesh.py:20). With device "cuda", shard i runs on
    cuda:(i % torch.cuda.device_count()) and n_devices defaults to the
    card count: on a machine with one card, a mesh of 4 puts all four
    shards on cuda:0. With device "cpu" every shard is on the CPU (the
    tests' counterpart of the reference's 8 virtual CPU devices) and
    n_devices defaults to 1. "cuda" without a card raises."""
    device = _device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        devices = (device,) * (1 if n_devices is None else n_devices)
    if not devices:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(devices, axis)


# ------------------------------------------------------------ collectives

def all_gather(mesh: Mesh, parts: list) -> list:
    """Every shard's part concatenated along dim 0 (the reference's
    `all_gather(..., tiled=True)`), one copy on each shard's device."""
    return [torch.cat([p.to(dev) for p in parts]) for dev in mesh.devices]


def ppermute(mesh: Mesh, parts: list, perm) -> list:
    """Shard dst receives shard src's part for each (src, dst) of `perm`;
    a shard that receives nothing gets zeros, as in JAX's ppermute."""
    out = [torch.zeros_like(p) for p in parts]
    for src, dst in perm:
        out[dst] = parts[src].to(mesh.devices[dst])
    return out


def _shard_rows(mesh: Mesh, x) -> list:
    """The rows of x split evenly over the shards, each on its device (a
    shard_map in_spec of P(axis))."""
    x = torch.as_tensor(x)
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    r = x.shape[0] // n
    return [x[i * r:(i + 1) * r].to(dev) for i, dev in enumerate(mesh.devices)]


def _place(out: torch.Tensor, offsets, sizes, owner: int, pay: torch.Tensor):
    """Write shard `owner`'s first sizes[owner] payload bytes at its
    stream offset in `out` (whose last slot parks the padding)."""
    pay = pay.reshape(-1)
    col = torch.arange(pay.shape[0], device=out.device)
    live = col < sizes[owner]
    dst = torch.where(live, offsets[owner] + col, out.shape[0] - 1)
    out.scatter_(0, dst, torch.where(live, pay, 0))


def _ragged_gather(mesh: Mesh, pays: list, sizes: list):
    """The ordered ragged gather over per-shard payloads [1, CAP] uint8
    and sizes [1]: each shard gathers the sizes, takes their exclusive prefix
    sums as offsets, gathers the payloads and places each at its offset.
    Returns shard 0's (gathered [n * CAP] uint8, total)."""
    n, cap = mesh.size, pays[0].shape[-1]
    all_sizes = all_gather(mesh, sizes)
    all_pay = all_gather(mesh, pays)
    outs = []
    for dev, sz, pay in zip(mesh.devices, all_sizes, all_pay):
        offsets = torch.cumsum(sz, 0) - sz
        out = torch.zeros(n * cap + 1, dtype=torch.uint8, device=dev)
        for d in range(n):
            _place(out, offsets, sz, d, pay[d])
        outs.append((out[:n * cap], sz.sum()))
    return outs[0]


def ragged_all_gather(mesh: Mesh, payload_pad, sizes):
    """Ordered variable-length gather (the reference's ragged_all_gather,
    tpz/parallel/mesh.py:353). payload_pad [n_dev, CAP] uint8: each
    shard's ragged payload, padded; sizes [n_dev]: their lengths. Returns
    (gathered [n_dev * CAP] uint8, the payloads concatenated in shard
    order and zero after; total) on shard 0's device."""
    return _ragged_gather(mesh, _shard_rows(mesh, payload_pad),
                          _shard_rows(mesh, sizes))


def ring_all_gather(mesh: Mesh, payload_pad, sizes):
    """ragged_all_gather's contract and output, with the payloads moved
    in n_dev - 1 ring `ppermute` hops instead of one all_gather (the
    reference's ring_all_gather, tpz/parallel/mesh.py:395): each round,
    every shard places the payload it holds, then passes it on."""
    pays = _shard_rows(mesh, payload_pad)
    n, cap = mesh.size, pays[0].shape[-1]
    all_sizes = all_gather(mesh, _shard_rows(mesh, sizes))
    outs = [torch.zeros(n * cap + 1, dtype=torch.uint8, device=dev)
            for dev in mesh.devices]
    ring = [(i, (i + 1) % n) for i in range(n)]
    for r in range(n):
        for i, sz in enumerate(all_sizes):
            _place(outs[i], torch.cumsum(sz, 0) - sz, sz, (i - r) % n,
                   pays[i])
        if r < n - 1:
            pays = ppermute(mesh, pays, ring)
    return outs[0][:n * cap], all_sizes[0].sum()


# ------------------------------------------------------- the encode step

def halo_rows(base: torch.Tensor, window: int, fwd: int,
              first_halo: torch.Tensor | None = None) -> torch.Tensor:
    """[NB, block] rows -> [NB, window + block + fwd] halo'd rows (the
    reference's halo_rows, tpz/parallel/mesh.py:27): each row gets the
    previous row's tail as its window halo (row 0: zeros, or `first_halo`
    [1, window]) and the next row's head as its forward pad."""
    block = base.shape[1]
    zeros = base.new_zeros
    prev_tail = torch.cat([zeros((1, window)) if first_halo is None
                           else first_halo.to(base.dtype),
                           base[:-1, block - window:]])
    next_head = torch.cat([base[1:, :fwd], zeros((1, fwd))])
    return torch.cat([prev_tail, base, next_head], dim=1)


def sharded_encode_step(mesh: Mesh, k: int = 4, window: int = 512,
                        block: int = 1024):
    """The sharded one-step encode (the reference's sharded_encode_step,
    tpz/parallel/mesh.py:46). Returns step(blocks [NB, block] bytes,
    span_off [NB] int32, span_len) -> (mlen, mdist, is_token [NB, block]
    on shard 0's device, counts [NB] int32: every block's token count).

    The blocks split evenly over the shards. Each shard's last `window`
    bytes go to the next shard by `ppermute` as its first row's halo
    (shard 0's halo is zeros: the span starts there); then each shard
    runs find_matches and greedy_parse, whose reach walk is the CUDA
    kernel of csrc/reach_walk.cu on a card, once per shard; the token
    counts are all-gathered in order."""
    from tpz_torch.kernels.matchfinder import find_matches
    from tpz_torch.kernels.parse import greedy_parse

    def step(blocks, span_off, span_len):
        bases = _shard_rows(mesh, blocks)
        offs = _shard_rows(mesh, span_off)
        n = mesh.size
        halos = ppermute(mesh, [b[-1:, block - window:] for b in bases],
                         [(i, i + 1) for i in range(n - 1)])
        outs = []
        for dev, base, so, halo in zip(mesh.devices, bases, offs, halos):
            haloed = halo_rows(base, window, FWD, halo).to(torch.int32)
            sl = torch.as_tensor(span_len, device=dev)
            mlen, mdist = find_matches(haloed, so, sl, k=k, window=window,
                                       block=block)
            block_len = torch.clamp(sl - so, 0, block).to(torch.int32)
            is_token, _, ntokens = greedy_parse(mlen, mdist, block_len)
            outs.append((mlen, mdist, is_token, ntokens))
        counts = all_gather(mesh, [o[3] for o in outs])[0]
        dev0 = mesh.devices[0]
        return tuple(torch.cat([o[i].to(dev0) for o in outs])
                     for i in range(3)) + (counts,)

    return step


# ------------------------------------------------------ sharded encodes

def sharded_compress(data: bytes, mesh: Mesh, k: int = 32,
                     level: int = 6) -> bytes:
    """Sharded gzip encode (the reference's sharded_compress,
    tpz/parallel/mesh.py:103): one gzip member per nonempty shard.

    The input is cut into spans of whole 64 KiB blocks, the same number
    of blocks for every shard (the last shards may get fewer bytes, or
    none). Each shard encodes its span as one DEFLATE stream on its
    device through deflate_pipeline (the v3 parse walk kernel of
    csrc/parse_walk.cu launches once a shard on a card); a span above
    MAX_DEVICE_SPAN goes to the oracle, counted in
    deflate_pipeline.host_declines, with the same bytes. The streams meet
    on shard 0 by the ordered ragged gather, and the host frames each as a
    member. Each member equals the gzip of its span alone. `k` is
    unused, as in the reference: the level's config sets the chain."""
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import deflate_pipeline as dp
    from tpz_torch.kernels.matchfinder import BLOCK

    n = len(data)
    if n == 0:  # the reference's empty member: the codec's default level
        return gzip_codec.compress(b"", device=mesh.devices[0])
    ndev = mesh.size
    cfg = DeflateConfig(level=level)
    nb_total = -(-n // BLOCK)
    nb_per = -(-nb_total // ndev)
    shard_bytes = nb_per * BLOCK
    spans = [data[d * shard_bytes:(d + 1) * shard_bytes] for d in range(ndev)]
    cap_bytes = 4 * ((9 * shard_bytes + 31) // 32 + 3 * nb_per + 16)

    pays, sizes = [], []
    for dev, chunk in zip(mesh.devices, spans):
        pay = torch.zeros(cap_bytes, dtype=torch.uint8, device=dev)
        if len(chunk) > dp.MAX_DEVICE_SPAN:
            body = torch.frombuffer(bytearray(dp._host_encode(chunk, cfg,
                                                              False)),
                                    dtype=torch.uint8).to(dev)
        elif chunk:
            layout = dp.span_layout([chunk])
            words, end_pos = dp._fused_encode(
                *(torch.from_numpy(a).to(dev) for a in layout[:6]), cfg,
                _nohook)
            body = words.view(torch.uint8)[:(int(end_pos[-1]) + 7) // 8]
        else:
            body = pay[:0]
        if body.numel() > cap_bytes:
            raise RuntimeError(f"shard stream of {body.numel()} bytes "
                               f"exceeds its {cap_bytes}-byte payload")
        pay[:body.numel()] = body
        pays.append(pay[None])
        sizes.append(torch.tensor([body.numel()], dtype=torch.int64,
                                  device=dev))
    gathered, _ = _ragged_gather(mesh, pays, sizes)
    blob = gathered.cpu().numpy()

    out = bytearray()
    hdr = gzip_codec.header_bytes(level)
    off = 0
    for chunk, sz in zip(spans, sizes):
        sz = int(sz)
        if sz == 0:
            continue
        crc = oracle.crc32_reflected(chunk) ^ 0xFFFFFFFF
        out += (hdr + blob[off:off + sz].tobytes()
                + struct.pack("<II", crc, len(chunk) & 0xFFFFFFFF))
        off += sz
    return bytes(out)


def sharded_compress_bzip2(data: bytes, mesh: Mesh, level: int = 9) -> bytes:
    """Sharded bzip2 encode (the reference's sharded_compress_bzip2,
    tpz/parallel/mesh.py:231): one stream per block.

    The host runs RLE1 and the block split once (the oracle); each shard
    takes a contiguous range of the blocks (the same count each, the
    last fewer) and encodes it on its device in dispatches of at most
    MAX_DISPATCH_BLOCKS (the MTF encode kernel of csrc/mtf_encode.cu on a
    card); every block opens its own stream. A dispatch's words come back
    to the host, which writes each block's 'BZh' header and end-of-stream
    trailer. A block's stream depends on its bytes alone, so the output
    is the same for every mesh size."""
    from tpz_torch.kernels import bzip2_pipeline as bp

    level = bp._level(level)
    if len(data) == 0:
        return bp.empty_stream(level)
    rle, off, ln, crc = oracle.bzip2_rle1(data, level)
    nb = off.size
    bpd = -(-nb // mesh.size)
    hdr = b"BZh" + bytes([0x30 + level])
    out = bytearray()
    for d, dev in enumerate(mesh.devices):
        lo, hi = d * bpd, min((d + 1) * bpd, nb)
        if lo >= hi:
            continue
        blocks = [(rle[off[b]:off[b] + ln[b]], int(crc[b]), True)
                  for b in range(lo, hi)]
        body, body_off, tb = bp.encode_layout(blocks, dev)
        for j in range(hi - lo):
            start_bit = int(body_off[j]) - 32  # word-aligned header gap
            end_bit = int(body_off[j] + tb[j])
            buf = bytearray(body[start_bit // 8:(end_bit + 7) // 8].tobytes())
            buf[0:4] = hdr
            out += bp._splice_eos(buf, end_bit - start_bit, [crc[lo + j]])
    return bytes(out)
