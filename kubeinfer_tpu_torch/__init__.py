"""PyTorch + CUDA port of the kubeinfer_tpu placement solver.

The JAX package ``kubeinfer_tpu`` is the reference; this package is its
counterpart for an NVIDIA Hopper card. It imports torch, numpy and the
standard library only — never jax, and nothing from ``kubeinfer_tpu``
(it keeps its own copies of what it needs). Entry points take
``device=None``, which means CUDA and raises when no CUDA device exists;
they run on the CPU only when the caller passes ``device="cpu"``.
"""

from kubeinfer_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
