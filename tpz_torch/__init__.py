"""tpz_torch — the PyTorch/CUDA port of tpz (see tpz/ for the JAX
reference). It imports torch and never jax, and loads nothing from tpz/:
its format tables, error classes and corpus are its own copies
(`constants`, `errors`, `utils.corpus`). The entry points are in
tpz_torch.api and run on the card (`device="cuda"`) unless the caller
asks for the CPU."""

import os

__version__ = "0.1.0"

# The checkout's root: the C++ oracle's sources (cpp/) and the build
# directory (build/) lie beside the package.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
