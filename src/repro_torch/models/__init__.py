from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec, cell_is_runnable
from repro_torch.models.registry import Arch, arch_names, get, make_batch, params_from_numpy

__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "cell_is_runnable",
    "Arch",
    "get",
    "arch_names",
    "make_batch",
    "params_from_numpy",
]
