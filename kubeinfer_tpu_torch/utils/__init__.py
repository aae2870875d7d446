"""Cross-cutting utilities: clock abstraction, logging, env config.

A copy of ``kubeinfer_tpu/utils/__init__.py`` for the PyTorch port.
"""

from kubeinfer_tpu_torch.utils.clock import Clock, RealClock, SimulatedClock

__all__ = ["Clock", "RealClock", "SimulatedClock"]
