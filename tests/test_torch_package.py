"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its metrics default to the GPU and never pick the CPU on their
own, and its kernel build raises instead of falling back."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torcheval_tpu_torch
from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.metrics import MulticlassAUROC
from torcheval_tpu_torch.ops import _build, ustat

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(torcheval_tpu_torch.__file__).resolve().parent

# `import jax`, `from jax...`, and any import of torcheval_tpu that is not
# torcheval_tpu_torch.
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|torcheval_tpu(?!_torch)\b)", re.M
)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax():
    offenders = [
        f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
        for path in _port_sources()
        for m in _FORBIDDEN.finditer(path.read_text())
    ]
    assert offenders == []
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from torcheval_tpu.ops import x")
    assert not _FORBIDDEN.search("from torcheval_tpu_torch.ops import x")


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "torcheval_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
import torcheval_tpu_torch
for mod in pkgutil.walk_packages(torcheval_tpu_torch.__path__, "torcheval_tpu_torch."):
    importlib.import_module(mod.name)
import torcheval_tpu_torch.convert
from torcheval_tpu_torch.metrics import MulticlassAUROC
rng = np.random.default_rng(0)
m = MulticlassAUROC(num_classes=4, device="cpu")
m.update(rng.random((64, 4)).astype(np.float32), rng.integers(0, 4, 64))
print(float(m.compute()))
assert not any(k.split(".")[0] in ("jax", "torcheval_tpu") for k in sys.modules)
"""


def test_port_imports_and_computes_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert 0.0 <= float(proc.stdout.strip().splitlines()[-1]) <= 1.0


def test_default_device_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MulticlassAUROC(num_classes=3)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'rank_sum.cu(3): error: no such thing' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such thing"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_is_keyed_by_the_sources():
    path = _build._library_path()
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(r"libtorcheval_tpu_torch_[0-9a-f]{16}\.so", path.name)
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {"auc_scan.cu", "rank_sum.cu"}


def test_a_refused_launch_raises():
    _build.check_launch("rank_sum", 0)
    with pytest.raises(RuntimeError, match="rank_sum failed to launch: cudaError 9"):
        _build.check_launch("rank_sum", 9)


def test_non_cuda_devices_are_refused():
    q = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ustat.rank_sum_counts(q, torch.zeros(2, 16, device="meta"))


def test_flags(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "yes")
    assert _flags.get("DISABLE_USTAT") is True
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "0")
    assert _flags.get("DISABLE_USTAT") is False
    # The JAX package's switches do not reach the port.
    monkeypatch.setenv("TORCHEVAL_TPU_DISABLE_USTAT", "1")
    assert _flags.get("DISABLE_USTAT") is False
    with pytest.raises(KeyError):
        _flags.get("DISABLE_PALLAS")
