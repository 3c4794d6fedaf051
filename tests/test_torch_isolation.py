"""The port stands alone: arbius_tpu_torch, chip_smoke.py and the port's
tools import neither JAX nor anything of arbius_tpu (nor safetensors),
and the port's entry points do not quietly run on the CPU."""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
# safetensors too: the card's machine has no such package, so the port
# reads the format itself (utils/checkpoint.py)
FORBIDDEN = ("jax", "jaxlib", "flax", "arbius_tpu", "safetensors")
SOURCES = sorted((REPO / "arbius_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "flash_mutants.py",
    REPO / "tools" / "flash_ablate.py", REPO / "tools" / "flash_same_bits.py",
    REPO / "tools" / "flash_times.py", REPO / "tools" / "node_run_trace.py",
    REPO / "tools" / "kandinsky2_flops.py",
    REPO / "tools" / "video_flops.py",
    REPO / "tools" / "video_conv_grouping.py",
    REPO / "tools" / "mesh_phase.py"]


def _imported(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_or_reference(path):
    bad = {n for n in _imported(path)
           if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_every_module_imports_without_jax_or_reference():
    script = (
        "import sys, pkgutil, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import arbius_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "arbius_tpu_torch.__path__, 'arbius_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 119


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    from arbius_tpu_torch.models.kandinsky2 import (
        Kandinsky2Config,
        Kandinsky2Pipeline,
    )
    from arbius_tpu_torch.models.rvm import RVMPipeline, RVMPipelineConfig
    from arbius_tpu_torch.models.sd15 import SD15Config, SD15Pipeline
    from arbius_tpu_torch.models.textgen import (
        TextGenConfig,
        TextGenPipeline,
    )
    from arbius_tpu_torch.models.video import (
        Text2VideoConfig,
        Text2VideoPipeline,
    )
    from arbius_tpu_torch.node import (
        MiningConfig,
        ModelConfig,
        build_anythingv3,
        build_registry,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_anythingv3(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_registry(MiningConfig(compile_cache_dir=None, models=(
            ModelConfig(id="0x" + "00" * 32, template="kandinsky2",
                        tiny=True),)))
    for template in ("damo", "zeroscopev2xl", "textgen",
                     "robust_video_matting"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_registry(MiningConfig(compile_cache_dir=None, models=(
                ModelConfig(id="0x" + "00" * 32, template=template,
                            tiny=True),)), resolve_file=lambda cid: None)
    for pipeline, config in ((SD15Pipeline, SD15Config),
                             (Kandinsky2Pipeline, Kandinsky2Config),
                             (Text2VideoPipeline, Text2VideoConfig),
                             (TextGenPipeline, TextGenConfig),
                             (RVMPipeline, RVMPipelineConfig)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline(config.tiny())
