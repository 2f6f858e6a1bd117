"""What a run loads: no JAX and not the JAX package, and a reference that
loads nothing of the program. Module names are compared by their whole
top-level name (the port's name begins with the JAX package's)."""

import ast
import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "tpz"}


def loaded_after(code: str) -> set:
    """Top-level names in sys.modules after `code` runs in a fresh
    interpreter from the repository's root."""
    r = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.splitlines()[-1]))


def test_harness_reference_and_every_cells_entry_load_no_jax():
    code = """
from benchmark import harness, manifest, controls, hooks
bench = manifest.Bench(".")
for c in bench.m["workloads"]:
    cfg = bench.config(c["config"])
    entry = bench.traffic(c["traffic"])["entry"]
    harness.program_entries(cfg, entry, "cpu")
    controls.control(cfg, entry)
    for m in bench.end_to_end(c["name"]) + bench.per_layer(c["name"]):
        bench.reader(m["name"])
"""
    loaded = loaded_after(code)
    assert "tpz_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(HERE, "reference", "*_ref.py")))
    assert mods
    loaded = loaded_after("\n".join(
        f"import benchmark.reference.{m}" for m in mods))
    assert not loaded & (FORBIDDEN | {"tpz_torch", "torch"})
    for m in mods:
        with open(os.path.join(HERE, "reference", f"{m}.py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"tpz_torch"}
