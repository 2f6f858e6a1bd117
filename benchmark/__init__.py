"""The benchmark of the PyTorch and CUDA port (`tpz_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one
JSON line; README.md beside this file says how cells, configurations,
traffic mixes and metric readers are found by name.
"""
