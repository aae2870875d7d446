"""PyTorch + CUDA port of kubeinfer_tpu: the placement solver and the
serving runtime.

The JAX package ``kubeinfer_tpu`` is the reference; this package is its
counterpart for an NVIDIA Hopper card. It solves (``solver``,
``scheduler``) and serves (``inference``: the per-request engine, the
continuous batcher and the ``/v1/completions`` server). It imports
torch, numpy and the standard library only — never jax, and nothing from
``kubeinfer_tpu`` (it keeps its own copies of what it needs). Entry
points take ``device=None``, which means CUDA and raises when no CUDA
device exists; they run on the CPU only when the caller passes
``device="cpu"``.
"""

from kubeinfer_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
