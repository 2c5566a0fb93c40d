from repro_torch.serve.engine import (
    FusedServingStep,
    ServePolicy,
    ServeTables,
    carry_from_arrays,
    serve_policy_step,
    serve_tables_from_arrays,
)

__all__ = [
    "FusedServingStep",
    "ServePolicy",
    "ServeTables",
    "carry_from_arrays",
    "serve_policy_step",
    "serve_tables_from_arrays",
]
