"""PyTorch/CUDA port of the SERF bird-acoustic preprocessing pipeline.

The layout mirrors `src/repro/` module for module; the JAX package is the
reference the port is tested against. The port imports neither JAX nor
anything of the JAX package. Entry points run on the CUDA card unless the
caller passes `device="cpu"`; kernel wrappers dispatch on the device of
the tensor they are given (CPU tensor: plain PyTorch version; CUDA tensor:
the hand-written Hopper kernel under `kernels/csrc/`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
