"""TOFEC core: the paper's contribution (delay model, Theorem-1 optimizer,
threshold-based adaptive controller)."""

from repro_torch.core.controller import (
    FeedbackPolicy,
    FixedKAdaptivePolicy,
    GreedyPolicy,
    MPCPolicy,
    MPCTables,
    Policy,
    StaticPolicy,
    TofecTables,
    TOFECPolicy,
    mpc_step,
    mpc_tables,
    tofec_step,
    tofec_threshold_step,
)
from repro_torch.core.delay_model import (
    PAPER_READ_3MB,
    PAPER_WRITE_3MB,
    DelayParams,
    RequestClass,
    fit_delay_params,
)
from repro_torch.core.static_optimizer import (
    ClassPlan,
    build_class_plan,
    optimal_static_code,
    q_for_k,
    solve_r_for_k,
)

__all__ = [
    "DelayParams",
    "RequestClass",
    "fit_delay_params",
    "PAPER_READ_3MB",
    "PAPER_WRITE_3MB",
    "Policy",
    "StaticPolicy",
    "TOFECPolicy",
    "GreedyPolicy",
    "FixedKAdaptivePolicy",
    "FeedbackPolicy",
    "MPCPolicy",
    "MPCTables",
    "mpc_step",
    "mpc_tables",
    "TofecTables",
    "tofec_step",
    "tofec_threshold_step",
    "ClassPlan",
    "build_class_plan",
    "optimal_static_code",
    "solve_r_for_k",
    "q_for_k",
]
