"""Control-plane controller: the batched LLMService reconciler.

Parity target: reference internal/controller/llmservice_controller.go
(Reconcile + desiredDeployment + SetupWithManager), redesigned around the
north-star insertion point (SURVEY.md §3.2): instead of a per-CR serial
I/O-dominated loop, one tick batches every pending replica across all CRs
into a single dense solve on the accelerator.

A copy of ``kubeinfer_tpu/controller/__init__.py`` for the PyTorch port.
"""

from kubeinfer_tpu_torch.controller.reconciler import Controller, ReconcileResult

__all__ = ["Controller", "ReconcileResult"]
