from repro_torch.fleet.sweep import (
    BIG,
    PolicySpec,
    fixedk_tables,
    policy_tables,
    static_tables,
)

__all__ = ["BIG", "PolicySpec", "fixedk_tables", "policy_tables", "static_tables"]
