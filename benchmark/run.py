"""Runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Without a card (or with fewer than the cell asks for) it exits 3 and
prints no result; a manifest that breaks the contract exits 2. The
numbers that decide `correct` are the last lines of standard error and
the last key ("checks") of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches of torch and CUDA, at fixed paths inside the checkout, so
# that only a checkout's first run builds. The program's own kernels and
# oracle build into build/ beside them.
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path[0] = ROOT
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "benchmark-cache", sub)
    from benchmark import manifest

    bench = manifest.Bench(ROOT)
    bad = manifest.validate(bench)
    if bad:
        print("BENCHMARK.json breaks the contract:", *bad, sep="\n  ",
              file=sys.stderr)
        return 2
    chips = bench.cell(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    from benchmark import harness

    result = harness.run(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
