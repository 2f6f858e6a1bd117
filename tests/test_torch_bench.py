"""`python -m tpz_torch bench` (tpz_torch/bench.py) against the
reference's bench.py: the same headline metric and row names (read from
bench.py's source, which is not run), the last line's form, every row on
device "cpu", the headline's ratio equal to the oracle's bytes plus the
gzip framing (the port's gzip bodies equal the oracle's), and no run on
device "cuda" without a card. The bench runs once, in-process, at 8 KiB
a buffer and one timed batch."""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from tpz_torch import REPO_ROOT, bench, oracle
from tpz_torch.codecs import gzip_codec
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.utils import corpus

SIZE = 8192
BUFFERS = 2
LAST_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "card",
             "device_ran", "errors", "skipped"}


def _reference_names():
    """(the headline metric, the rows of extra_metrics in source order)
    from the reference's bench.py."""
    with open(os.path.join(REPO_ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    rows = []
    for node in ast.walk(fns["extra_metrics"]):
        name = None
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "run"):
            name = node.args[0].value
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name) and node.value.id == "out"
              and isinstance(node.slice, ast.Constant)):
            name = node.slice.value
        if name is not None and name not in rows:
            rows.append(name)
    rows.sort(key=lambda n: _first_line(fns["extra_metrics"], n))
    metrics = {v.value for node in ast.walk(fns["main"])
               if isinstance(node, ast.Dict)
               for k, v in zip(node.keys, node.values)
               if isinstance(k, ast.Constant) and k.value == "metric"}
    assert len(metrics) == 1
    return metrics.pop(), rows


def _first_line(fn, name):
    return min(node.lineno for node in ast.walk(fn)
               if isinstance(node, ast.Constant) and node.value == name)


@pytest.fixture(scope="module")
def run():
    """bench.main on device "cpu": (exit code, its stdout lines). One
    torch thread: the plain walks' ops are tiny, and intra-op threads
    contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--device", "cpu", "--bytes", str(SIZE),
                             "--buffers", str(BUFFERS), "--iters", "1"])
    finally:
        torch.set_num_threads(threads)
    return rc, out.getvalue().splitlines()


def test_names_equal_the_reference(run):
    metric, rows = _reference_names()
    _, lines = run
    assert len(rows) == 12
    assert json.loads(lines[-1])["metric"] == metric == bench.METRIC
    assert list(json.loads(lines[-2])["detail"]["extra_metrics"]) == rows


def test_last_line_on_the_cpu(run):
    rc, lines = run
    assert rc == 0 and len(lines) == 2
    assert len(lines[-1].encode()) < 1024
    last = json.loads(lines[-1])
    assert set(last) == LAST_KEYS
    assert last["value"] is None and last["device_ran"] is False
    assert last["vs_baseline"] is None and last["card"] is None
    assert last["backend"] == "cpu" and last["unit"] == "GB/s/chip"
    assert last["errors"] == [] and last["skipped"] == []


def test_detail_holds_every_row_without_error(run):
    _, lines = run
    detail = json.loads(lines[-2])["detail"]
    rows = detail["extra_metrics"]
    assert len(rows) == 12
    for name, row in rows.items():
        assert "error" not in row and "skipped" not in row, (name, row)
        assert row["MB_s"] > 0, name
        assert ("MB_s_cold" in row) == name.endswith(
            ("_device", "_batched", "_foreign")), name
        assert "roofline" not in row, name
    assert "rates" not in detail and "roofline" not in detail["headline"]
    assert detail["build"]["oracle"]["cache"] in ("found", "compiled")
    assert "kernels" not in detail["build"]


def test_headline_ratio_equals_the_oracles(run):
    _, lines = run
    head = json.loads(lines[-2])["detail"]["headline"]
    assert head["bytes"] == SIZE * BUFFERS and len(head["all_s"]) == 1
    params = DeflateConfig(6).params_array()
    framing = len(gzip_codec.header_bytes(6)) + 8
    want = sum(framing + len(oracle.deflate_encode(
        corpus.mixed(SIZE, seed=7 + i), params)) for i in range(BUFFERS))
    assert head["compression_ratio"] == want / (SIZE * BUFFERS)


def test_cuda_without_a_card_runs_no_row():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    r = subprocess.run([sys.executable, "-m", "tpz_torch", "bench",
                        "--device", "cuda"], capture_output=True, text=True,
                       cwd=REPO_ROOT, env=dict(os.environ,
                                               PYTHONPATH=REPO_ROOT),
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "torch.cuda.is_available() is False" in r.stderr
