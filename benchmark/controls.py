"""The control and the faults: entries put in the program's place that
must make `correct` come out false. The benchmark's own runs use none of
them.

The control is the plain reference in the program's place with one
guarantee of the configuration broken, by the least departure that
breaks it:
  compress_many    the stock writer's streams with the integrity field
                   left out (zeroed by the reference's
                   `break_integrity`: gzip's trailer CRC-32, bzip2's
                   combined stream CRC). Skipping the checksum is the
                   step that would tempt a later change: it is host time
                   in every request.
  decompress_many  the stock reader's plaintext short of its last byte.

The faults, planted under any entry (the program's or a stand-in):
  unchanged   the entry hands its inputs back unchanged
  half_batch  the second half of a request's outputs are copies of the
              first half's (half of the batch left out)
  altered     one byte of one output flipped where it is produced

    python3 benchmark/controls.py --workload <cell> --seeds <n> [<n> ...]

runs the control at the cell's own size, one short run a seed, and prints
each run's compared numbers.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def control(cfg: dict, entry: str):
    """(api call, hooked call) of the control for the configuration."""
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    level = cfg["level"]
    if entry == "compress_many":
        def call(batch):
            return [ref.break_integrity(ref.encode(d, level))
                    for d in batch]
    else:
        def call(batch):
            return [ref.decode(s)[:-1] for s in batch]
    return call, lambda batch, hook: call(batch)


def stand_in(cfg: dict, entry: str):
    """(api call, hooked call) of the plain reference in the program's
    place, breaking nothing: the tests' sound run on the CPU."""
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    level = cfg["level"]
    if entry == "compress_many":
        def call(batch):
            return [ref.encode(d, level) for d in batch]
    else:
        def call(batch):
            return [ref.decode(s) for s in batch]
    return call, lambda batch, hook: call(batch)


def unchanged(call):
    return lambda batch: list(batch)


def half_batch(call):
    def broken(batch):
        out = call(batch)
        h = (len(out) + 1) // 2
        return out[:h] + out[:len(out) - h]
    return broken


def altered(call):
    def broken(batch):
        out = list(call(batch))
        s = bytearray(out[-1])
        s[len(s) // 2] ^= 0x01
        out[-1] = bytes(s)
        return out
    return broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control at a cell's size")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from benchmark import harness, manifest

    bench = manifest.Bench(root)
    spec = bench.cell(args.workload)
    cfg = bench.config(spec["config"])
    entry = bench.traffic(spec["traffic"])["entry"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run(bench, args.workload, seed, args.seconds, False,
                          t_start=t0, device="cpu",
                          entries=control(cfg, entry))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": True, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
