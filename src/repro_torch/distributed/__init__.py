"""Distribution: logical-axis sharding rules, gradient compression."""
from repro_torch.distributed.api import (
    RULES_1D, RULES_2D, RULES_3D, AxisRules, axis_rules, constrain,
    logical_to_spec, named_sharding,
)
from repro_torch.distributed import compression

__all__ = [
    "RULES_1D", "RULES_2D", "RULES_3D", "AxisRules", "axis_rules",
    "compression", "constrain", "logical_to_spec", "named_sharding",
]
