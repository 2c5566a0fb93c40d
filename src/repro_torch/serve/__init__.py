from repro_torch.serve.engine import (
    ClosedLoopResult,
    ClosedLoopServer,
    FusedServingStep,
    ServePolicy,
    ServeResult,
    ServeTables,
    ServingEngine,
    carry_from_arrays,
    serve_policy_step,
    serve_tables_from_arrays,
    tokens_from_strips,
)

__all__ = [
    "ClosedLoopResult",
    "ClosedLoopServer",
    "FusedServingStep",
    "ServePolicy",
    "ServeResult",
    "ServeTables",
    "ServingEngine",
    "carry_from_arrays",
    "serve_policy_step",
    "serve_tables_from_arrays",
    "tokens_from_strips",
]
