"""The port's inference runtime: the bf16 serving path of
``kubeinfer_tpu/inference`` in PyTorch, with hand-written CUDA kernels
for its attention (``flash_attention.py``, ``csrc/``).

A llama-family decoder (``model.py``), the per-request engine
(``engine.Engine``: chunked prefill, then a fused decode loop), the
continuous batcher over a paged KV pool (``batching.ContinuousEngine``,
``stepper.decode_window``, ``kv_blocks``; with preemption, load
shedding and drain/migration), speculative decoding (the
side-car ``speculative.SpeculativeEngine`` and the batcher's verify
windows, ``stepper.verify_window``), JAX-equal threefry sampling
(``prng.py``) and the OpenAI-style HTTP server (``server.py``).
"""

from kubeinfer_tpu_torch.inference.batching import (
    EngineDrainingError,
    EngineOverloadedError,
    PreemptionPolicy,
)
from kubeinfer_tpu_torch.inference.config import PRESETS, ModelConfig
from kubeinfer_tpu_torch.inference.model import forward, init_params

__all__ = ["EngineDrainingError", "EngineOverloadedError", "ModelConfig",
           "PRESETS", "PreemptionPolicy", "forward", "init_params"]
