"""Control plane: the in-process API server equivalent.

The reference's coordination bus is the Kubernetes API server — every
controller Get/Create/Update and every agent Lease operation is a round-trip
to it (SURVEY.md §3.2, §3.3). kubeinfer_tpu ships its own versioned object
store with the same semantics the components rely on: optimistic concurrency
via resourceVersion, create-conflict atomicity, and watch streams — so the
whole framework runs self-contained (tests = envtest tier) or against a real
cluster later by swapping this module behind the same interface.

A copy of ``kubeinfer_tpu/controlplane/__init__.py`` for the PyTorch
port.
"""

from kubeinfer_tpu_torch.controlplane.store import (
    ConflictError,
    NotFoundError,
    AlreadyExistsError,
    Store,
    WatchEvent,
)

__all__ = [
    "AlreadyExistsError",
    "ConflictError",
    "NotFoundError",
    "Store",
    "WatchEvent",
]
