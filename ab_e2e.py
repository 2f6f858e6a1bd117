#!/usr/bin/env python3
"""A parent checkout against this one, in turns on one NVIDIA GPU: the
end-to-end metrics of the gzip encode path and of the lh5 and bzip2
decode paths, through the LZHUF
token walk (#5) and the inverse BWT (#7), those two wrappers at the
headline shapes, and the two public functions no codec path reaches, the
greedy reach walk (#8) and the v3w parse walk (#9).

    git archive <parent commit> | tar -x -C build/parent
    python3 ab_e2e.py build/parent [--pairs 3]

Each run is a process of its own on one checkout (its kernels and oracle
build into that checkout's build/), in the order parent, change, change,
parent, ... over the same 2 x 16 MiB of corpus.mixed (seeds 1000, 1001,
as chip_smoke.py) and the same oracle bzip2 level-9 streams of it. A run
prints one JSON line: gzip encode MB/s (api.compress_many at level 6
on the buffers, as chip_smoke.py phase 5 but the same buffers each
call), lh5 decode MB/s (of the blobs the run's own api.compress_many
writes, which equal the oracle's) and bzip2 decode MB/s (median of 3
warm calls, as chip_smoke.py phases 5, 11 and 15), `lzhuf_walk`
on the segmented layout of the first buffer's lh5 body (the headline
decode dispatch's own input; with the layout's end-bit hint where the
checkout has one) and `ibwt` on the headline bzip2 batch's last columns
at the checkout's own IBWT_SEG, `reach_walk` on the steps of the gzip
level-6 parse of the buffers and `parse_extend_v3w` on that parse's
screen (chip_smoke.py phase 19's headline), each by CUDA events, mean
of 5 warm calls. The last line gives each metric's runs by side. Needs
both checkouts' chip_smoke.py, whose functions make the inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

METRICS = ("gzip_encode_mb_s", "lh5_decode_mb_s", "bzip2_decode_mb_s",
           "lzhuf_walk_ms", "ibwt_ms", "reach_walk_ms", "v3w_ms")


def run_side(data_path: str) -> dict:
    """The metrics of the checkout on sys.path[0] (its chip_smoke.py and
    tpz_torch), on the buffers and bzip2 streams saved at data_path."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from tpz_torch import api, oracle
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import bzip2_walk as bw
    from tpz_torch.kernels import ibwt_walk as iw
    from tpz_torch.kernels import lzhuf_walk as lw
    from tpz_torch.kernels import parse

    saved = np.load(data_path)
    bufs = [saved[f"buf{i}"].tobytes() for i in range(cs.HEADLINE_BUFFERS)]
    bz = [saved[f"bz{i}"].tobytes() for i in range(cs.HEADLINE_BUFFERS)]
    total = sum(map(len, bufs))
    lz = api.compress_many(bufs, cs.LZHUF_METHOD, device="cuda")
    out = {}
    for name, fn in (
            ("gzip_encode_mb_s",
             lambda: api.compress_many(bufs, "gzip", level=cs.LEVEL,
                                       device="cuda")),
            ("lh5_decode_mb_s",
             lambda: api.decompress_many(lz, cs.LZHUF_METHOD,
                                         device="cuda")),
            ("bzip2_decode_mb_s",
             lambda: api.decompress_many(bz, "bzip2", device="cuda"))):
        fn()
        median, _ = cs.warm_median(lambda _: fn(), range(3))
        out[name] = round(total / median / 1e6, 2)
    bits = cs._dict_bits(cs.LZHUF_METHOD)
    body = oracle.lzhuf_encode(bufs[0], bits, 16)
    t = cs.lzhuf_walk_inputs(body, len(bufs[0]), cs.LZHUF_METHOD)
    kw = {"walk_end_bit": t["walk_end_bit"]} if "walk_end_bit" in t else {}
    run = lambda: lw.lzhuf_walk(*lw._walk_args(t), **kw)
    run()
    _, out["lzhuf_walk_ms"] = cs.timed(run, 5)
    del t
    t, N, S = cs.bzip2_layout(bz)
    recs, meta = bw.bzip2_walk(*(t[k] for k in bw.WALK_ARGS), S)
    args = cs.ibwt_inputs(t, recs, meta, N)
    del recs, t
    run = lambda: iw.ibwt(*args, iw.IBWT_SEG)
    run()
    _, out["ibwt_ms"] = cs.timed(run, 5)
    del args
    cfg = DeflateConfig(level=cs.LEVEL)
    inputs = cs.parse_inputs(bufs, cfg, "cuda")
    pk1, pk2, _, words, bl = inputs
    pargs = cs._parse_args(cfg)
    mlen = parse.parse_extend_v3(*inputs, *pargs)[1]
    step = torch.where(mlen >= 3, mlen, 1).to(torch.int32).contiguous()
    for name, run in (
            ("reach_walk_ms", lambda: parse.reach_walk(step)),
            ("v3w_ms", lambda: parse.parse_extend_v3w(pk1, pk2, words, bl,
                                                      *pargs[:7]))):
        run()
        _, out[name] = cs.timed(run, 5)
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", nargs="?",
                    help="a checkout of the parent commit")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--run", nargs=2, metavar=("ROOT", "DATA"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        root, data = args.run
        sys.path.insert(0, root)
        print(json.dumps(run_side(data)), flush=True)
        return 0

    if args.parent is None:
        ap.error("the parent checkout is required")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np
    import chip_smoke as cs

    smi = cs.phase_device()
    t0 = time.perf_counter()
    bufs = cs.make_corpus([(cs.HEADLINE_BYTES, 1000 + i)
                           for i in range(cs.HEADLINE_BUFFERS)])
    data = os.path.join(here, "build", "ab_e2e_data.npz")
    os.makedirs(os.path.dirname(data), exist_ok=True)
    from tpz_torch import oracle

    np.savez(data, **{f"buf{i}": np.frombuffer(b, np.uint8)
                      for i, b in enumerate(bufs)},
             **{f"bz{i}": np.frombuffer(oracle.bzip2_encode(b, 9), np.uint8)
                for i, b in enumerate(bufs)})
    roots = {"parent": os.path.abspath(args.parent), "change": here}
    runs = {m: {"parent": [], "change": []} for m in METRICS}
    order = [side for i in range(args.pairs)
             for side in (("parent", "change") if i % 2 == 0
                          else ("change", "parent"))]
    for side in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", roots[side], data],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"{side} run failed:\n{r.stderr[-3000:]}")
        got = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, **got}), flush=True)
        for m in METRICS:
            runs[m][side].append(got[m])
    print(json.dumps({"card": smi, "order": order, "seconds": round(
        time.perf_counter() - t0, 1), "runs": runs, "medians": {
        m: {s: statistics.median(v) for s, v in sides.items()}
        for m, sides in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
