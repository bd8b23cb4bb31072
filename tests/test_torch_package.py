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
from torcheval_tpu_torch.ops import _flags as ops_flags

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(torcheval_tpu_torch.__file__).resolve().parent

# `import jax`, `from jax...`, any import of torcheval_tpu that is not
# torcheval_tpu_torch, and the JAX flagship's module.
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|torcheval_tpu(?!_torch)\b|__graft_entry__\b)",
    re.M,
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
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert {
        "torcheval_tpu_torch/flagship.py",
        "torcheval_tpu_torch/ops/cm.py",
        "torcheval_tpu_torch/ops/binned.py",
        "torcheval_tpu_torch/metrics/classification/auprc.py",
        "torcheval_tpu_torch/metrics/classification/binned_auc.py",
        "torcheval_tpu_torch/metrics/classification/binned_precision_recall_curve.py",
        "torcheval_tpu_torch/metrics/classification/precision_recall_curve.py",
        "torcheval_tpu_torch/metrics/classification/recall_at_fixed_precision.py",
        "torcheval_tpu_torch/metrics/functional/classification/auprc.py",
        "torcheval_tpu_torch/metrics/functional/classification/binned_auc.py",
        "torcheval_tpu_torch/metrics/functional/classification/binned_precision_recall_curve.py",
        "torcheval_tpu_torch/metrics/functional/classification/precision_recall_curve.py",
        "torcheval_tpu_torch/metrics/functional/classification/recall_at_fixed_precision.py",
        "torcheval_tpu_torch/distributed.py",
        "torcheval_tpu_torch/metrics/_bucket.py",
        "torcheval_tpu_torch/metrics/collection.py",
        "torcheval_tpu_torch/metrics/toolkit.py",
        "torcheval_tpu_torch/telemetry/events.py",
        "torcheval_tpu_torch/telemetry/export.py",
        "torcheval_tpu_torch/telemetry/flightrec.py",
        "torcheval_tpu_torch/telemetry/health.py",
        "torcheval_tpu_torch/telemetry/trace.py",
        "torcheval_tpu_torch/telemetry/__main__.py",
        "torcheval_tpu_torch/telemetry/perfscope.py",
        "torcheval_tpu_torch/telemetry/tenants.py",
        "torcheval_tpu_torch/serve/__init__.py",
        "torcheval_tpu_torch/serve/admission.py",
        "torcheval_tpu_torch/serve/metering.py",
        "torcheval_tpu_torch/serve/registry.py",
        "torcheval_tpu_torch/serve/service.py",
        "torcheval_tpu_torch/resilience/checkpoint.py",
        "torcheval_tpu_torch/resilience/faults.py",
        "torcheval_tpu_torch/resilience/membership.py",
        "torcheval_tpu_torch/resilience/retry.py",
        "torcheval_tpu_torch/ops/_mega_plan.py",
        "torcheval_tpu_torch/ops/mega.py",
        "torcheval_tpu_torch/engine/__init__.py",
        "torcheval_tpu_torch/engine/scan.py",
        "torcheval_tpu_torch/engine/prefetch.py",
        "torcheval_tpu_torch/aot.py",
        "torcheval_tpu_torch/_stats.py",
        "torcheval_tpu_torch/parallel/_compile_cache.py",
        "torcheval_tpu_torch/monitor/__init__.py",
        "torcheval_tpu_torch/monitor/quality.py",
        "torcheval_tpu_torch/monitor/decay.py",
        "torcheval_tpu_torch/monitor/window.py",
        "torcheval_tpu_torch/monitor/digest.py",
        "torcheval_tpu_torch/ops/rank_sketch.py",
        "torcheval_tpu_torch/metrics/_rank_state.py",
        "torcheval_tpu_torch/metrics/_sketch.py",
        "torcheval_tpu_torch/utils/test_utils/dummy_metric.py",
        "torcheval_tpu_torch/utils/test_utils/metric_class_tester.py",
        "torcheval_tpu_torch/native/edit_distance.py",
        "torcheval_tpu_torch/ops/wavefront.py",
        "torcheval_tpu_torch/metrics/text/_tokens.py",
        "torcheval_tpu_torch/metrics/text/bleu.py",
        "torcheval_tpu_torch/metrics/text/perplexity.py",
        "torcheval_tpu_torch/metrics/text/word_error_rate.py",
        "torcheval_tpu_torch/metrics/functional/text/bleu.py",
        "torcheval_tpu_torch/metrics/functional/text/perplexity.py",
        "torcheval_tpu_torch/metrics/functional/text/word_error_rate.py",
        "torcheval_tpu_torch/metrics/classification/binary_normalized_entropy.py",
        "torcheval_tpu_torch/metrics/functional/classification/binary_normalized_entropy.py",
        "torcheval_tpu_torch/metrics/aggregation/click_through_rate.py",
        "torcheval_tpu_torch/metrics/functional/aggregation/mean.py",
        "torcheval_tpu_torch/parallel/__init__.py",
        "torcheval_tpu_torch/parallel/exact.py",
        "torcheval_tpu_torch/parallel/mesh.py",
        "torcheval_tpu_torch/parallel/sync.py",
        "torcheval_tpu_torch/metrics/functional/regression/mean_squared_error.py",
        "torcheval_tpu_torch/metrics/functional/regression/r2_score.py",
        "torcheval_tpu_torch/metrics/regression/mean_squared_error.py",
        "torcheval_tpu_torch/metrics/regression/r2_score.py",
        "torcheval_tpu_torch/metrics/functional/ranking/frequency.py",
        "torcheval_tpu_torch/metrics/functional/ranking/hit_rate.py",
        "torcheval_tpu_torch/metrics/functional/ranking/num_collisions.py",
        "torcheval_tpu_torch/metrics/functional/ranking/reciprocal_rank.py",
        "torcheval_tpu_torch/metrics/functional/ranking/retrieval.py",
        "torcheval_tpu_torch/metrics/functional/ranking/weighted_calibration.py",
        "torcheval_tpu_torch/metrics/ranking/_scores.py",
        "torcheval_tpu_torch/metrics/ranking/hit_rate.py",
        "torcheval_tpu_torch/metrics/ranking/reciprocal_rank.py",
        "torcheval_tpu_torch/metrics/ranking/retrieval.py",
        "torcheval_tpu_torch/metrics/ranking/weighted_calibration.py",
        "torcheval_tpu_torch/metrics/window/auroc.py",
        "torcheval_tpu_torch/metrics/window/click_through_rate.py",
        "torcheval_tpu_torch/metrics/window/mean_squared_error.py",
        "torcheval_tpu_torch/metrics/window/normalized_entropy.py",
        "torcheval_tpu_torch/metrics/window/weighted_calibration.py",
        "torcheval_tpu_torch/metrics/functional/image/_precision.py",
        "torcheval_tpu_torch/metrics/functional/image/fid.py",
        "torcheval_tpu_torch/metrics/functional/image/psnr.py",
        "torcheval_tpu_torch/metrics/functional/image/ssim.py",
        "torcheval_tpu_torch/metrics/image/fid.py",
        "torcheval_tpu_torch/metrics/image/psnr.py",
        "torcheval_tpu_torch/metrics/image/ssim.py",
        "torcheval_tpu_torch/tools/__init__.py",
        "torcheval_tpu_torch/tools/flops.py",
        "torcheval_tpu_torch/tools/module_summary.py",
        "torcheval_tpu_torch/tools/profiling.py",
        "torcheval_tpu_torch/tools/roofline.py",
        "torcheval_tpu_torch/routing.py",
        "torcheval_tpu_torch/routing_autotune.py",
    } <= scanned
    assert _FORBIDDEN.search("from __graft_entry__ import entry")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from torcheval_tpu.ops import x")
    assert not _FORBIDDEN.search("from torcheval_tpu_torch.ops import x")


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "torcheval_tpu", "__graft_entry__"):
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
from torcheval_tpu_torch.flagship import FlagshipMLP, eval_step
out = eval_step(FlagshipMLP(device="cpu"), rng.random((64, 32)), rng.integers(0, 8, 64))
assert int(out["confusion_matrix"].sum()) == 64
from torcheval_tpu_torch.metrics import BinaryBinnedAUROC, MulticlassAUPRC
ap = MulticlassAUPRC(num_classes=4, device="cpu")
ap.update(rng.random((64, 4)).astype(np.float32), rng.integers(0, 4, 64))
assert 0.0 <= float(ap.compute()) <= 1.0
auc, grid = BinaryBinnedAUROC(threshold=50, device="cpu").update(
    rng.random(64), rng.integers(0, 2, 64)).compute()
assert 0.0 <= float(auc) <= 1.0 and grid.shape == (50,)
import os
os.environ["TORCHEVAL_TPU_TORCH_MEGAKERNEL"] = "1"
from torcheval_tpu_torch.metrics import MetricCollection, MulticlassConfusionMatrix
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute
from torcheval_tpu_torch.distributed import LocalWorld
col = MetricCollection({"cm": MulticlassConfusionMatrix(4, device="cpu")}, bucket=True)
col.fused_update(rng.random((64, 4)).astype(np.float32), rng.integers(0, 4, 64))
synced = LocalWorld(2).run(lambda g, r: sync_and_compute(col, g, "all"))
assert int(synced[0]["cm"].sum()) == 128
from torcheval_tpu_torch.metrics import BLEUScore, Mean, Perplexity, WordErrorRate
from torcheval_tpu_torch.metrics.text._tokens import tokenize_pairs
wer = WordErrorRate(device="cpu").update(*tokenize_pairs(["a b c"], ["a x c d"]))
assert wer.update(["a b"], ["a b"]).errors.item() == 2.0
text = MetricCollection({"ppl": Perplexity(device="cpu"), "wer": WordErrorRate(device="cpu")})
text.update(rng.random((2, 5, 7)).astype(np.float32), rng.integers(0, 7, (2, 5)))
assert float(text.compute()["ppl"]) > 1.0
assert float(BLEUScore(n_gram=2, device="cpu").update("a b c", "a b c").compute()) == 1.0
assert float(Mean(device="cpu").update(torch.ones(3), 2.0).compute()) == 1.0
from torcheval_tpu_torch.metrics import (
    FrechetInceptionDistance, StructuralSimilarity, WindowedBinaryAUROC)
win = WindowedBinaryAUROC(max_num_samples=8, device="cpu")
for _ in range(3):
    win.update(rng.random(5).astype(np.float32), rng.integers(0, 2, 5))
assert win._num_valid == 8 and 0.0 <= float(win.compute()) <= 1.0
img = torch.rand(2, 3, 16, 16)
assert float(StructuralSimilarity(device="cpu").update(img, img).compute()) > 0.999
fid = FrechetInceptionDistance(lambda x: x.flatten(1)[:, :4], feature_dim=4, device="cpu")
fid.update(img, is_real=True).update(img.flip(0), is_real=False)
assert abs(float(fid.compute())) < 1e-3
import tempfile
from torcheval_tpu_torch import telemetry
from torcheval_tpu_torch.resilience import CheckpointManager, FaultPlan, ResilientGroup, RetryPolicy
telemetry.enable()
telemetry.health.enable()
col.fused_update(rng.random((64, 4)).astype(np.float32), np.full(64, 9))
assert telemetry.report()["data_health"]["checks"]["label_range:cm"]["count"] == 64
with FaultPlan([{"site": "collective", "on_attempt": 1, "count": 2}]):
    got = LocalWorld(2).run(
        lambda g, r: ResilientGroup(g, RetryPolicy(base_delay=0.001)).all_gather_object(r))
assert got == [[0, 1], [0, 1]] and len(telemetry.events_snapshot("retry")) == 2
with tempfile.TemporaryDirectory() as d:
    CheckpointManager(d).save(col.state_dict(), {"batches_seen": 2})
    assert CheckpointManager(d).load_latest().cursor == {"batches_seen": 2}
assert "local_all_gather_object" in telemetry.prometheus_text()
from torcheval_tpu_torch.metrics import BinaryAUROC
from torcheval_tpu_torch.monitor import Decayed, SlidingWindow, StreamDigest
sk = BinaryAUROC(sketch=True, device="cpu").update(rng.random(64), rng.integers(0, 2, 64))
assert 0.0 <= float(LocalWorld(2).run(lambda g, r: sync_and_compute(sk, g, "all", sketch="rank"))[0]) <= 1.0
assert Decayed(MulticlassConfusionMatrix(4, device="cpu"), decay=0.5).update(
    rng.integers(0, 4, 64), rng.integers(0, 4, 64)).compute().dtype == torch.float32
assert SlidingWindow(MulticlassConfusionMatrix(4, device="cpu"), buckets=2).update(
    rng.integers(0, 4, 64), rng.integers(0, 4, 64)).advance().epochs_advanced == 1
assert StreamDigest(device="cpu").update(rng.random(64)).compute().shape == (3,)
assert not any(
    k.split(".")[0] in ("jax", "torcheval_tpu", "__graft_entry__") for k in sys.modules
)
"""


def test_port_imports_and_computes_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert 0.0 <= float(proc.stdout.strip().splitlines()[-1]) <= 1.0


_TOP_LEVEL = """
import sys
import torcheval_tpu_torch
from torcheval_tpu_torch.ops import _build
assert not any(k.split(".")[0] in ("jax", "jaxlib", "torcheval_tpu") for k in sys.modules)
assert _build._load.cache_info().currsize == 0  # no kernel library built or loaded
for name in torcheval_tpu_torch.__all__:
    assert getattr(torcheval_tpu_torch, name) is not None
print(" ".join(torcheval_tpu_torch.__all__))
"""


def test_top_level_exports_the_jax_layers():
    import torcheval_tpu

    assert set(torcheval_tpu_torch.__all__) == set(torcheval_tpu.__all__)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _TOP_LEVEL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == torcheval_tpu_torch.__all__


def test_tools_export_the_jax_names_that_have_a_counterpart():
    import torcheval_tpu.tools as jax_tools

    import torcheval_tpu_torch.tools as port_tools

    # They read XLA's compiled objects (tools/flops.py's docstring).
    absent = {"memory_stats_of", "normalize_cost_analysis"}
    assert set(port_tools.__all__) == set(jax_tools.__all__) - absent
    for name in port_tools.__all__:
        assert getattr(port_tools, name) is not None


def test_kv_timeout_flag_raises_on_a_bad_value(monkeypatch):
    from torcheval_tpu_torch.distributed import kv_timeout_ms

    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS", raising=False)
    assert kv_timeout_ms() == 600_000 and "TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS" not in (
        _flags.snapshot_non_default())
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS", "2500")
    assert kv_timeout_ms() == 2500
    assert _flags.snapshot_non_default()["TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS"] == 2500
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS", " ")  # blank: unset, as in JAX
    assert kv_timeout_ms() == 600_000
    for bad in ("0", "-5", "1.5", "soon"):
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS", bad)
        with pytest.raises(ValueError, match="KV_TIMEOUT_MS must be a positive integer"):
            kv_timeout_ms()
        assert _flags.snapshot_non_default()["TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS"] == {
            "raw": bad, "invalid": True}
    # The JAX package's variable does not reach the port.
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS")
    monkeypatch.setenv("TORCHEVAL_TPU_KV_TIMEOUT_MS", "7")
    assert kv_timeout_ms() == 600_000


def test_ops_exports_the_jax_names_that_have_a_counterpart():
    import torcheval_tpu.ops as jax_ops

    import torcheval_tpu_torch.ops as port_ops

    # No DISABLE_PALLAS and no wavefront switch in the port, so no
    # availability flag and no route choice to export (the module's
    # docstring says so).
    absent = {"has_pallas", "pallas_binary_auroc", "wavefront_route"}
    assert set(port_ops.__all__) == set(jax_ops.__all__) - absent
    for name in port_ops.__all__:
        assert callable(getattr(port_ops, name))
    assert port_ops.has_fused() is True
    thresholds = torch.tensor([[0.9, 0.8, 0.8, 0.1]])
    hits = torch.tensor([[1, 0, 1, 0]], dtype=torch.int8)
    assert float(port_ops.auc_from_sorted(thresholds, hits)[0]) == 0.875


def test_parallel_exports_the_jax_names_that_have_a_counterpart():
    import torcheval_tpu.parallel as jax_parallel
    from torcheval_tpu.parallel import exact as jax_exact

    import torcheval_tpu_torch.parallel as port_parallel
    from torcheval_tpu_torch.parallel import exact as port_exact

    # The jit cache's introspection has no counterpart.
    missing = {"spmd_cache_clear", "spmd_cache_info"}
    # The port's own Mesh class stands where the JAX package takes
    # jax.sharding.Mesh.
    assert set(port_parallel.__all__) - {"Mesh"} == set(jax_parallel.__all__) - missing
    for name in port_parallel.__all__:
        assert getattr(port_parallel, name) is not None
    assert callable(port_exact.eager_ustat_pin) and callable(jax_exact.eager_ustat_pin)


def test_telemetry_and_resilience_export_the_jax_names_of_the_ported_modules():
    import torcheval_tpu.resilience as jax_resilience
    import torcheval_tpu.telemetry as jax_telemetry

    import torcheval_tpu_torch.resilience as port_resilience
    import torcheval_tpu_torch.telemetry as port_telemetry

    assert port_resilience.__all__ == jax_resilience.__all__
    assert port_telemetry.__all__ == jax_telemetry.__all__
    for name in ("SloRule", "default_rules", "explain_perf", "profile", "perfscope",
                 "tenants", "format_explain_perf"):
        assert name in port_telemetry.__all__
    for mod in (port_telemetry, port_resilience):
        for name in mod.__all__:
            assert getattr(mod, name) is not None
    from torcheval_tpu_torch.telemetry import export

    assert callable(export.fleet_to_perfetto) and callable(export.format_fleet_report)
    # Every public name of the two JAX modules that has a counterpart.
    import torcheval_tpu.telemetry.perfscope as jax_perfscope
    import torcheval_tpu.telemetry.tenants as jax_tenants

    for jax_mod, port_mod in ((jax_perfscope, port_telemetry.perfscope),
                              (jax_tenants, port_telemetry.tenants)):
        public = {n for n in vars(jax_mod) if not n.startswith("_")
                  and callable(getattr(jax_mod, n)) and getattr(
                      getattr(jax_mod, n), "__module__", "") == jax_mod.__name__}
        assert {n for n in public if not hasattr(port_mod, n)} == set()


def test_serve_exports_the_jax_names():
    import torcheval_tpu.serve as jax_serve

    import torcheval_tpu_torch.serve as port_serve

    assert port_serve.__all__ == jax_serve.__all__
    for name in port_serve.__all__:
        assert getattr(port_serve, name) is not None
    with pytest.raises(AttributeError):
        port_serve.NoSuchName
    from torcheval_tpu_torch.serve import (
        admission,
        cluster,
        metering,
        placement,
        registry,
        service,
    )

    for mod in (admission, cluster, metering, placement, registry, service):
        assert mod.__name__.startswith("torcheval_tpu_torch.serve.")
    assert port_serve.ServeCluster.__module__ == "torcheval_tpu_torch.serve.cluster"
    assert port_serve.HashRing.__module__ == "torcheval_tpu_torch.serve.placement"


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
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "auc_scan.cu",
        "binned_count.cu",
        "binned_wcount.cu",
        "cm_slab.cu",
        "rank_hist.cu",
        "mega.cu",
        "rank_sum.cu",
        "token_nll.cu",
        "wavefront.cu",
    }


def test_a_refused_launch_raises():
    _build.check_launch("rank_sum", 0)
    with pytest.raises(RuntimeError, match="rank_sum failed to launch: cudaError 9"):
        _build.check_launch("rank_sum", 9)


def test_non_cuda_devices_are_refused():
    q = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ustat.rank_sum_counts(q, torch.zeros(2, 16, device="meta"))


def test_every_csrc_entry_has_a_signature():
    entries = {
        m.group(1)
        for src in _build.CSRC.glob("*.cu")
        for m in re.finditer(r'extern "C" int (\w+)\(', src.read_text())
    }
    assert entries == set(_build._SIGNATURES)


def test_integer_flags(monkeypatch):
    assert _flags.get_int("CM_ROW_CHUNK") == 4096
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK", "256")
    assert _flags.get_int("CM_ROW_CHUNK") == 256
    for invalid in ("300", "-4", "0", "many"):
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK", invalid)
        assert _flags.get_int("CM_ROW_CHUNK") == 4096
    with pytest.raises(KeyError):
        _flags.get_int("DISABLE_USTAT")


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
    # No switch sends GPU tensors past the edit-distance kernel.
    with pytest.raises(KeyError):
        _flags.get_tristate("WAVEFRONT")


def test_megakernel_flag_is_tristate(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raising=False)
    assert _flags.get_tristate("MEGAKERNEL") is None
    for raw, want in (("1", True), ("On", True), ("0", False), ("off", False),
                      ("auto", None), ("", None)):
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raw)
        assert _flags.get_tristate("MEGAKERNEL") is want
        assert ops_flags.megakernel_mode() is want
    # The JAX package's switch does not reach the port.
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL")
    monkeypatch.setenv("TORCHEVAL_TPU_MEGAKERNEL", "1")
    assert _flags.get_tristate("MEGAKERNEL") is None
    with pytest.raises(KeyError):
        _flags.get_tristate("DISABLE_USTAT")
    with pytest.raises(KeyError):
        _flags.get("MEGAKERNEL")


def test_counters_lose_no_increment_across_threads():
    import threading

    _build.reset_counts()

    def count():
        for _ in range(2000):
            _build.count_launch("binned_weighted_counts")
            _build.count_plain("binned_weighted_counts")

    threads = [threading.Thread(target=count) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _build.LAUNCHES["binned_weighted_counts"] == 16000
    assert _build.PLAIN_CALLS["binned_weighted_counts"] == 16000
    _build.reset_counts()


def test_threads_that_reach_the_first_build_together_build_once(monkeypatch):
    import threading
    import time

    builds = []

    def fake_build():
        builds.append(1)
        time.sleep(0.05)  # long enough for the other threads to arrive
        return "libfake.so"

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    _build._load.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(_build.library()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(builds) == 1 and len(libs) == 8 and len({id(x) for x in libs}) == 1
    finally:
        _build._load.cache_clear()
