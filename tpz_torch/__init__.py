"""tpz_torch — the PyTorch/CUDA port of tpz (see tpz/ for the JAX
reference). It imports torch and never jax; the entry points are in
tpz_torch.api and take an explicit `device`."""

__version__ = "0.1.0"
