"""Registers the marker of the tests that need a card, and gives the
tests a copy of the benchmark whose traffic is cut to sizes a test run
holds. A test marked `card` decides inside itself whether a card is
there, never while the module is imported."""

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Object bytes of each traffic in the tests' copy; each pool holds two
# requests.
SMALL = {"archive.2x16MiB": 65536, "read.4x4MiB": 16384,
         "read.2x16MiB": 65536}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without one. Run on "
                   "the card: python3 -m pytest benchmark/tests -q")


def copy_bench(dst: str) -> str:
    """A copy of BENCHMARK.json and the benchmark's data files under dst
    (the harness's code stays the repository's)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(HERE, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return dst


@pytest.fixture
def small_root(tmp_path):
    root = copy_bench(str(tmp_path))
    for name, nbytes in SMALL.items():
        path = os.path.join(root, "benchmark", "traffic", f"{name}.json")
        with open(path) as f:
            t = json.load(f)
        t["object_bytes"] = nbytes
        t["pool_objects"] = 2 * t["objects_per_request"]
        with open(path, "w") as f:
            json.dump(t, f)
    return root


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda"
