"""Resource API types (copies of ``kubeinfer_tpu/api``)."""

from kubeinfer_tpu_torch.api.types import (
    CacheStrategy,
    Condition,
    LLMService,
    LLMServiceList,
    LLMServiceSpec,
    LLMServiceStatus,
    ObjectMeta,
    SchedulerPolicy,
    ValidationError,
    parse_quantity,
)

__all__ = [
    "CacheStrategy",
    "Condition",
    "LLMService",
    "LLMServiceList",
    "LLMServiceSpec",
    "LLMServiceStatus",
    "ObjectMeta",
    "SchedulerPolicy",
    "ValidationError",
    "parse_quantity",
]
