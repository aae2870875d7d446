from kubeinfer_tpu_torch.api.types import SchedulerPolicy

__all__ = ["SchedulerPolicy"]
