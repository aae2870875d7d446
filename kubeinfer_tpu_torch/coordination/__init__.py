"""Coordination: lease-based leader election with automatic failover.

Parity target: reference internal/agent/coordinator/election.go:17-225 —
custom Lease CRUD election (not client-go's leaderelection), 15s TTL / 10s
renew / 2s retry, steal-on-expiry with optimistic CAS, role-flip callbacks.

A copy of ``kubeinfer_tpu/coordination/__init__.py`` for the PyTorch
port.
"""

from kubeinfer_tpu_torch.coordination.lease import (
    LEASE_DURATION_S,
    RENEW_INTERVAL_S,
    RETRY_INTERVAL_S,
    Lease,
    LeaseManager,
)

__all__ = [
    "LEASE_DURATION_S",
    "RENEW_INTERVAL_S",
    "RETRY_INTERVAL_S",
    "Lease",
    "LeaseManager",
]
