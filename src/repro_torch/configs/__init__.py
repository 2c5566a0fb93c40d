"""Exact per-architecture configs of the ported families (one module each).

Copies of the reference package's ``repro/configs`` modules, every family's,
in the reference's order, and the port's own (:data:`PORT_CONFIGS`). Import
side-effect free; each module exports ``CONFIG`` plus a ``smoke_config()``
returning a reduced same-family config for CPU tests.
"""

from repro_torch.configs import (
    deepseek_v3,
    gemma2_2b,
    grok_1_314b,
    mistral_nemo_12b,
    mixtral_8x7b,
    nemotron3_nano_30b_a3b,
    pixtral_12b,
    qwen1_5_0_5b,
    whisper_base,
    xlstm_350m,
    yi_6b,
    zamba2_2_7b,
)

_MODULES = [whisper_base, xlstm_350m, gemma2_2b, mistral_nemo_12b, yi_6b, qwen1_5_0_5b,
            pixtral_12b, grok_1_314b, mixtral_8x7b, zamba2_2_7b]

ALL_CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}

SMOKE_CONFIGS = {m.CONFIG.name: m.smoke_config() for m in _MODULES}

#: The architectures only the port has (the reference package runs none of
#: them): served through the same registry, outside the mirrored ten.
_PORT_MODULES = [nemotron3_nano_30b_a3b, deepseek_v3]

PORT_CONFIGS = {m.CONFIG.name: m.CONFIG for m in _PORT_MODULES}

PORT_SMOKE_CONFIGS = {m.CONFIG.name: m.smoke_config() for m in _PORT_MODULES}
