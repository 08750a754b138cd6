"""cse_tpu_torch imports torch only: never jax, flax, optax or cse_tpu."""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import cse_tpu_torch

PKG_DIR = Path(cse_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG_DIR)], prefix="cse_tpu_torch.")
    )


def test_every_module_imports_without_jax_or_cse_tpu():
    mods = ["cse_tpu_torch"] + _modules()
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(PKG_DIR.parent),
    )
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [
        m for m in loaded
        if m.split(".")[0] in FORBIDDEN or m == "cse_tpu" or m.startswith("cse_tpu.")
    ]
    assert not bad, bad
    assert "cse_tpu_torch.serving" in loaded and "torch" in loaded
    assert "cse_tpu_torch.core.mesh" in loaded  # the data-parallel layer is held to the same rule


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG_DIR).as_posix() for p in PKG_DIR.rglob("*.py")))
def test_sources_have_no_forbidden_imports(path):
    src = (PKG_DIR / path).read_text()
    pat = re.compile(
        r"^\s*(?:import|from)\s+(?:" + "|".join(FORBIDDEN) + r"|cse_tpu)(?:\.|\s|$)", re.M
    )
    assert not pat.findall(src), pat.findall(src)


def test_package_has_kernel_sources():
    assert (PKG_DIR / "csrc" / "fused_stack.cu").exists()


@pytest.mark.parametrize("name", ["fused_train.cu", "common.cuh"])
def test_package_has_training_kernel_sources(name):
    assert (PKG_DIR / "csrc" / name).exists()


@pytest.mark.parametrize("name", ["attention.cu", "fused_stack_w8a8.cu"])
def test_package_has_flash_and_w8a8_kernel_sources(name):
    assert (PKG_DIR / "csrc" / name).exists()


TRAINER_MODULES = [
    "ops.kernel_parts", "ops.mixing", "ops.resample", "data.audio_io", "data.tokenizer", "data.datasets",
    "data.synthetic", "data.pipeline", "models.context_encoder", "train.checkpoint", "train.loop", "core.flags",
    "core.banner", "utils.logging", "utils.profiling", "train_ContExt", "train_ContSep", "train_Sepformer",
    "scripts.bench_kernel_parts", "eval.evaluator", "eval.metrics", "eval.host_metrics", "eval.pesq",
    "compat.torch_import", "compat.torch_export", "test", "bench", "core.cli",
    "models.llama", "compat.safetensors_io", "native.audio_native",
    "models.ecapa", "models.speaker_encoder", "eval.enrollment", "train_HContExt", "test_HContExt",
]


@pytest.mark.parametrize("name", TRAINER_MODULES)
def test_trainer_and_tool_modules_are_walked(name):
    """The trainer's and the eval's modules, the seven entry points, the
    speaker encoders and the kernel-parts tool are modules of the package, so
    the two tests above cover them."""
    assert f"cse_tpu_torch.{name}" in _modules()
    assert (PKG_DIR / (name.replace(".", "/") + ".py")).exists()


def test_package_has_kernel_parts_source_and_build_lists_it():
    from cse_tpu_torch.ops import _build

    assert (PKG_DIR / "csrc" / "kernel_parts.cu").exists()
    assert "kernel_parts.cu" in _build.SOURCES
    assert {"cse_kp_layer_norm", "cse_kp_attention"} <= set(_build.SIGNATURES)
    assert sorted(_build.SOURCES) == sorted(p.name for p in (PKG_DIR / "csrc").glob("*.cu"))


def test_chip_smoke_imports_nothing_forbidden():
    src = (PKG_DIR.parent / "chip_smoke.py").read_text()
    pat = re.compile(r"^\s*(?:import|from)\s+(?:" + "|".join(FORBIDDEN) + r"|cse_tpu)(?:\.|\s|$)", re.M)
    assert not pat.findall(src), pat.findall(src)


@pytest.mark.parametrize("name", ["models.llama", "compat.safetensors_io", "native.audio_native"])
def test_llama_and_native_modules_need_neither_safetensors_nor_transformers(name):
    """The card's machine has neither package: the Llama loader reads
    safetensors files with the port's own reader."""
    src = (PKG_DIR / (name.replace(".", "/") + ".py")).read_text()
    pat = re.compile(r"^\s*(?:import|from)\s+(?:safetensors|transformers)(?:\.|\s|$)", re.M)
    assert not pat.findall(src), pat.findall(src)
    code = (f"import sys; sys.modules['safetensors'] = None; sys.modules['transformers'] = None\n"
            f"import cse_tpu_torch.{name}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(PKG_DIR.parent))
    assert out.returncode == 0, out.stderr


def test_native_source_is_the_ports_own_copy():
    assert (PKG_DIR / "native" / "audio_io.cc").exists()
    assert not list((PKG_DIR / "native").glob("*.so"))
