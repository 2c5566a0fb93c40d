"""The port, chip_smoke.py, obs_cost.py, k1_ablation.py and k2_ablation.py import
neither jax nor the reference package."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import repro_torch.models, repro_torch.configs
repro_torch.models.get("qwen1.5-0.5b").cfg.param_count_dense()
import chip_smoke
chip_smoke.request_class()
chip_smoke.k1_bound(32, 64, 48, 524288)
import k1_ablation
import k2_ablation
import obs_cost
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("SLICE", sorted(m for m in sys.modules
                     if m.startswith(("repro_torch.taskq", "repro_torch.sched"))))
print("LM", sorted(m for m in sys.modules
                  if m.startswith(("repro_torch.models", "repro_torch.configs"))))
print("LAUNCH", sorted(m for m in sys.modules if m.startswith("repro_torch.launch")))
print("OBS", sorted(m for m in sys.modules if m.startswith("repro_torch.obs")))
print("TRAIN", sorted(m for m in sys.modules
                     if m.startswith(("repro_torch.train", "repro_torch.ckpt", "repro_torch.data",
                                      "repro_torch.tree"))))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["LOADED"]) >= 60  # every module of the port was imported
    assert lines["SLICE"] == str([f"repro_torch.{pkg}{mod}" for pkg, mods in (
        ("sched", ("", ".frontier", ".scan", ".sweep")),
        ("taskq", ("", ".engine", ".policies", ".sweep"))) for mod in mods])
    assert lines["LM"] == str([f"repro_torch.{pkg}{mod}" for pkg, mods in (
        ("configs", ("", ".deepseek_v3", ".gemma2_2b", ".grok_1_314b", ".mistral_nemo_12b",
                     ".mixtral_8x7b", ".nemotron3_nano_30b_a3b", ".pixtral_12b", ".qwen1_5_0_5b",
                     ".whisper_base", ".xlstm_350m", ".yi_6b", ".zamba2_2_7b")),
        ("models", ("", ".config", ".deepseek_v3", ".encdec", ".hybrid", ".layers", ".lm",
                    ".mla", ".moe", ".nemotron_h", ".registry", ".sharding", ".ssm", ".xlstm")))
        for mod in mods])
    assert lines["LAUNCH"] == str([f"repro_torch.launch{mod}" for mod in (
        "", ".dryrun", ".mesh", ".report", ".roofline", ".specs")])
    assert lines["OBS"] == str([f"repro_torch.obs{mod}" for mod in (
        "", ".compile", ".dashboard", ".flight", ".meta", ".metrics", ".profile", ".slo",
        ".state", ".timeline", ".trace")])
    assert lines["TRAIN"] == str(sorted([
        "repro_torch.ckpt", "repro_torch.ckpt.checkpoint", "repro_torch.data",
        "repro_torch.data.pipeline", "repro_torch.train", "repro_torch.train.optimizer",
        "repro_torch.train.train_step", "repro_torch.train.trainer", "repro_torch.tree"]))
    assert lines["BAD"] == "[]", lines["BAD"]


def test_port_sources_name_no_jax_import():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "obs_cost.py", ROOT / "k1_ablation.py",
        ROOT / "k2_ablation.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: {line}"


#: Reference modules whose counterpart in the port has another name.
RENAMED = {"core/jax_sim.py": "core/fluid_scan.py"}


def test_every_reference_module_has_its_port():
    """The port is complete: each module of ``src/repro/`` has a counterpart
    at the same path in ``src/repro_torch/`` (or at its named rename)."""
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = [str(path) for path in sorted(p.relative_to(ref).as_posix()
                                            for p in ref.rglob("*.py"))
               if not (port / RENAMED.get(path, path)).is_file()]
    assert missing == []
    assert all((port / new).is_file() and not (port / old).exists()
               for old, new in RENAMED.items())
