"""The reference package's jax-free files, loaded by path.

`import tpz.<anything>` runs `tpz/__init__.py`, which imports jax. The
spec tables (`tpz/constants.py`), the error classes (`tpz/errors.py`) and
the synthetic corpus (`tpz/utils/corpus.py`) import only numpy or the
standard library, so they are loaded here straight from their files under
private module names. Both packages then read one source of format tables.
"""

from __future__ import annotations

import importlib.util
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(REPO_ROOT, "tpz")


def _load(name: str, relpath: str):
    modname = f"tpz_torch._ref_{name}"
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(REF_PKG, relpath))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


constants = _load("constants", "constants.py")
errors = _load("errors", "errors.py")
corpus = _load("corpus", os.path.join("utils", "corpus.py"))
