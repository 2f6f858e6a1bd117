#!/usr/bin/env python3
"""A parent checkout against this one, in turns on one NVIDIA GPU: the
end-to-end metrics of the gzip main path, through the v3 parse walk (#1)
and the inflate symbol walk (#2), and those two wrappers at the headline
shapes.

    git archive <parent commit> | tar -x -C build/parent
    python3 ab_e2e.py build/parent [--pairs 3]

Each run is a process of its own on one checkout (its kernels and oracle
build into that checkout's build/), in the order parent, change, change,
parent, ... over the same 2 x 16 MiB of corpus.mixed (seeds 1000, 1001,
as chip_smoke.py). A run prints one JSON line: gzip encode (level 6) and
gzip decode MB/s (median of 3 warm calls, as chip_smoke.py phases 5 and
8, all on the same buffers), `parse_extend_v3` on the headline's parse
inputs and `symbol_walk` on the segmented layout of the first buffer's
gzip body (the headline decode dispatch's own input; with the layout's
end-bit hint where the checkout has one), both by CUDA events, mean of 5
warm calls. The last line gives each metric's runs by side. Needs both
checkouts' chip_smoke.py, whose functions make the inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

METRICS = ("gzip_encode_mb_s", "gzip_decode_mb_s", "parse_v3_ms",
           "symbol_walk_ms")


def run_side(data_path: str) -> dict:
    """The metrics of the checkout on sys.path[0] (its chip_smoke.py and
    tpz_torch), on the buffers saved at data_path."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from tpz_torch import api
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import inflate_pipeline as ip
    from tpz_torch.kernels import parse

    bufs = [a.tobytes() for a in np.load(data_path).values()]
    total = sum(map(len, bufs))
    gz = api.compress_many(bufs, "gzip", 6, device="cuda")
    out = {}
    for name, fn in (
            ("gzip_encode_mb_s",
             lambda: api.compress_many(bufs, "gzip", 6, device="cuda")),
            ("gzip_decode_mb_s",
             lambda: api.decompress_many(gz, "gzip", device="cuda"))):
        fn()
        median, _ = cs.warm_median(lambda _: fn(), range(3))
        out[name] = round(total / median / 1e6, 2)
    cfg = DeflateConfig(level=6)
    inputs = cs.parse_inputs(bufs, cfg, "cuda")
    args = cs._parse_args(cfg)
    run = lambda: parse.parse_extend_v3(*inputs, *args)
    run()
    _, out["parse_v3_ms"] = cs.timed(run, 5)
    del inputs
    t = cs.segmented_inputs(gz[0][len(gzip_codec.header_bytes(6)):-8])
    kw = {"walk_end_bit": t["walk_end_bit"]} if "walk_end_bit" in t else {}
    run = lambda: ip.symbol_walk(*ip._walk_args(t), **kw)
    run()
    _, out["symbol_walk_ms"] = cs.timed(run, 5)
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
    np.savez(data, *[np.frombuffer(b, np.uint8) for b in bufs])
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
