from .npu_exec import (  # noqa: F401
    npu_execution,
    npu_forward,
)
from .quantize import (  # noqa: F401
    QuantStats,
    agreement,
    fake_quant_tree,
    npu_variant,
    quant_error_stats,
)
