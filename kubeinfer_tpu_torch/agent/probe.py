"""Node hardware observation for the node-state vectors.

Counterpart of ``kubeinfer_tpu/agent/probe.py``. The agent derives its
capacity vector from the hardware it actually sees:

- accelerators: the local CUDA cards, ``torch.cuda.device_count()`` and
  ``torch.cuda.mem_get_info(i)`` (free and total bytes) of each (the
  reference asks ``jax.local_devices()`` and their ``memory_stats()``);
- host memory: /proc/meminfo (the bound on host-side model caching).

Everything degrades to None on machines without the source (no card,
no /proc) so env-configured capacity keeps working everywhere.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class AcceleratorInfo:
    count: int
    platform: str
    memory_bytes: int  # total device memory across local cards (0 = unknown)
    memory_free_bytes: int  # meaningful only when memory_free_known
    # free == 0 is ambiguous between "stats unavailable" and "genuinely
    # exhausted" — and the exhausted case is exactly what the heartbeat
    # observer must report, so knownness is explicit
    memory_free_known: bool = False


def probe_accelerators() -> AcceleratorInfo | None:
    """Observe the LOCAL CUDA cards; None when there is none.

    ``mem_get_info`` (``cudaMemGetInfo``) counts memory held by every
    process on a card as used: what the heartbeat needs to see external
    usage.
    """
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        n = torch.cuda.device_count()
        total = free = 0
        for i in range(n):
            f, t = torch.cuda.mem_get_info(i)
            free += int(f)
            total += int(t)
    except Exception as e:  # no torch / no CUDA runtime / init failure
        log.debug("accelerator probe unavailable: %s", e)
        return None
    if n == 0:
        return None
    return AcceleratorInfo(
        count=n,
        platform="gpu",
        memory_bytes=total,
        memory_free_bytes=free,
        memory_free_known=total > 0,
    )


def probe_host_memory() -> tuple[int, int] | None:
    """(total, available) bytes from /proc/meminfo; None off-Linux."""
    try:
        fields = {}
        with open("/proc/meminfo", "r", encoding="ascii") as f:
            for line in f:
                key, _, rest = line.partition(":")
                fields[key.strip()] = rest
        total = int(fields["MemTotal"].split()[0]) * 1024
        avail = int(fields["MemAvailable"].split()[0]) * 1024
        return total, avail
    except (OSError, KeyError, ValueError, IndexError):
        return None
