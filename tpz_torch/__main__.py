"""CLI: python -m tpz_torch {compress,decompress,selftest} ...

The port of `python -m tpz`, with `-b/--backend` replaced by `--device`
(default "cuda"; "cuda" without a card fails). Each command prints one
JSON line of statistics to stderr, as the reference's does. `bench` is not
here: the port's bench is its own later work.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpz_torch", description="lossless compression on a torch device")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the codec runs (default: cuda)")

    def add_io(sp):
        sp.add_argument("input", help="input file, or - for stdin")
        sp.add_argument("-o", "--output", default=None,
                        help="output file (default: stdout for -, else "
                             "input+suffix / stripped suffix)")
        sp.add_argument("-f", "--format", default="gzip",
                        help="gzip|zlib|deflate|bzip2|lh4..lh7|lzss")
        add_common(sp)

    c = sub.add_parser("compress", help="compress a file")
    add_io(c)
    c.add_argument("-l", "--level", type=int, default=6)
    d = sub.add_parser("decompress", help="decompress a file")
    add_io(d)
    s = sub.add_parser("selftest",
                       help="round-trip every format on synthetic data")
    s.add_argument("-n", type=int, default=1 << 16)
    add_common(s)
    args = p.parse_args(argv)

    from tpz_torch import api

    if args.cmd == "selftest":
        from tpz_torch.utils import corpus

        data = corpus.mixed(args.n)
        ok = True
        for fmt in api.formats():
            t0 = time.time()
            comp = api.compress(data, fmt, device=args.device)
            t1 = time.time()
            good = api.decompress(comp, fmt, device=args.device) == data
            t2 = time.time()
            ok &= good
            print(f"{fmt:8s} {'OK ' if good else 'FAIL'} "
                  f"ratio={len(comp)/len(data):.3f} "
                  f"enc={len(data)/max(t1-t0,1e-9)/1e6:.1f}MB/s "
                  f"dec={len(data)/max(t2-t1,1e-9)/1e6:.1f}MB/s")
        return 0 if ok else 1

    if args.input == "-":
        raw = sys.stdin.buffer.read()
    else:
        with open(args.input, "rb") as f:
            raw = f.read()
    suffix = {"gzip": ".gz", "zlib": ".zz", "deflate": ".deflate",
              "bzip2": ".bz2"}.get(args.format, "." + args.format)
    t0 = time.time()
    if args.cmd == "compress":
        out = api.compress(raw, args.format, level=args.level,
                           device=args.device)
        default_out = None if args.input == "-" else args.input + suffix
    else:
        out = api.decompress(raw, args.format, device=args.device)
        default_out = (args.input[: -len(suffix)]
                       if args.input.endswith(suffix) else
                       (None if args.input == "-" else args.input + ".out"))
    dt = time.time() - t0
    dest = args.output or default_out
    if dest is None or dest == "-":
        sys.stdout.buffer.write(out)
    else:
        with open(dest, "wb") as f:
            f.write(out)
    print(json.dumps({
        "cmd": args.cmd, "format": args.format, "in_bytes": len(raw),
        "out_bytes": len(out), "seconds": round(dt, 4),
        "mb_per_s": round(len(raw) / max(dt, 1e-9) / 1e6, 2),
        "output": dest or "<stdout>",
    }), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
