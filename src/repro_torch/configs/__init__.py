"""Exact per-architecture configs of the dense family (one module each).

Copies of the reference package's ``repro/configs`` modules for the dense
family. Import side-effect free; each module exports ``CONFIG`` plus a
``smoke_config()`` returning a reduced same-family config for CPU tests.
The MoE, VLM, encoder-decoder, SSM and hybrid configs wait for the port of
their families (ROADMAP item 13).
"""

from repro_torch.configs import gemma2_2b, mistral_nemo_12b, qwen1_5_0_5b, yi_6b

_MODULES = [gemma2_2b, mistral_nemo_12b, yi_6b, qwen1_5_0_5b]

ALL_CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}

SMOKE_CONFIGS = {m.CONFIG.name: m.smoke_config() for m in _MODULES}
