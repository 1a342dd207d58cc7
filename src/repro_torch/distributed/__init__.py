"""The distribution layer: logical-axis rules and DTensor placements
(``partitioning``), the per-architecture policy and model placement
(``sharding``), gradient compression (``compression``) and GPipe stages
(``pipeline``).  The port of ``repro.distributed``."""
from .partitioning import (
    DEFAULT_RULES,
    SP_RULES,
    LogicalRules,
    get_rules,
    logical_to_spec,
    rules_for_mesh,
    set_rules,
    shard,
    use_rules,
)

__all__ = [
    "DEFAULT_RULES", "SP_RULES", "LogicalRules", "get_rules",
    "logical_to_spec", "rules_for_mesh", "set_rules", "shard", "use_rules",
]
