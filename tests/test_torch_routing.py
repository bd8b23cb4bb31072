"""The port's ``routing`` (``torcheval_tpu_torch.routing``) against the JAX
package's deciders: on the same numpy-seeded data, the route each
explanation names is the one the JAX decider picks with its backend set to
the TPU (the JAX tests' own mock), with the port's CUDA kernel in the
place of "Pallas", and the kernel it names is the one the call counts.
Cases from ``tests/test_routing.py``."""

import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics.functional.classification import confusion_matrix as jcm
from torcheval_tpu.ops import pallas_ustat as justat

import torcheval_tpu_torch.metrics.functional as F
import torcheval_tpu_torch.parallel as P
from torcheval_tpu_torch import _stats, routing
from torcheval_tpu_torch.metrics import (
    MetricCollection,
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    WindowedBinaryAUROC,
)
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops.wavefront import edit_distance_tokens
from torcheval_tpu_torch.routing import (
    RouteDowngradeWarning,
    explain_route,
    reset_route_warnings,
    route_kernel,
    warn_route_downgrade,
)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for flag in ("DISABLE_USTAT", "MEGAKERNEL", "CM_ROW_CHUNK", "AUTOTUNE", "AUTOTUNE_DIR"):
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_" + flag, raising=False)
    reset_route_warnings()
    _build.reset_counts()
    yield
    _build.reset_counts()


def _on_tpu():
    return mock.patch("jax.default_backend", return_value="tpu")


def _called(fn, *args, **kwargs):
    """The plain-version keys one CPU call of ``fn`` counts."""
    _build.reset_counts()
    fn(*args, **kwargs)
    return set(_build.PLAIN_CALLS)


# (N, C, class distribution): rare classes, skewed, small N, balanced wide.
_USTAT_DATA = {
    "rare-classes": (2**15, 200, None),
    "headline-shape": (2**17, 1000, None),
    "skewed": (2**15, 8, None),
    "small-n": (2**14, 200, None),
    "one-hot-class": (2**15, 300, "one"),
}


def _ustat_data(case):
    n, c, mode = _USTAT_DATA[case]
    rng = np.random.default_rng(len(case) + n)
    s = rng.random((n, c), dtype=np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    if mode == "one":
        t[: n // 2] = 3  # one class holds half the samples
    return s, t, c


@pytest.mark.parametrize("case", sorted(_USTAT_DATA))
@pytest.mark.parametrize("fn", ["multiclass_auroc", "multiclass_auprc"])
def test_rank_route_and_cap_match_the_jax_decider(case, fn):
    s, t, c = _ustat_data(case)
    with _on_tpu():
        want = justat.ustat_route_cap(jnp.asarray(s), jnp.asarray(t), c)
    port_fn = getattr(F, fn)
    msg = explain_route(port_fn, torch.from_numpy(s), torch.from_numpy(t), num_classes=c)
    key = route_kernel(port_fn, torch.from_numpy(s), torch.from_numpy(t), num_classes=c)
    rank = "rank_sum_counts" if fn == "multiclass_auroc" else "rank_hist_counts"
    if want is None:
        assert "sort" in msg and key == ("auc_from_sorted" if fn == "multiclass_auroc" else None)
    else:
        assert f"table cap {want}" in msg and key == rank
        assert "ops/csrc/" in msg and "Pallas" not in msg
    assert _called(port_fn, torch.from_numpy(s), torch.from_numpy(t), num_classes=c) == (
        {key} if key else set())


def test_route_switch_is_named_and_a_pinned_cap_is_explained(monkeypatch):
    s, t, c = _ustat_data("rare-classes")
    args = (torch.from_numpy(s), torch.from_numpy(t))
    assert "pinned at 512" in explain_route(F.multiclass_auroc, *args, num_classes=c, ustat_cap=512)
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "1")
    msg = explain_route(F.multiclass_auroc, *args, num_classes=c)
    assert "DISABLE_USTAT is set" in msg and route_kernel(
        F.multiclass_auroc, *args, num_classes=c) == "auc_from_sorted"


@pytest.mark.parametrize("positives", [0.001, 0.5, 0.999])
@pytest.mark.parametrize("fn", ["binary_auroc", "binary_auprc"])
def test_binary_rank_route_matches_the_jax_decider(positives, fn):
    rng = np.random.default_rng(int(positives * 1000))
    s = rng.random((2, 2**16), dtype=np.float32)
    t = (rng.random((2, 2**16)) < positives).astype(np.int32)
    with _on_tpu():
        want = justat.binary_ustat_route(jnp.asarray(s), jnp.asarray(t),
                                         need_pos=fn == "binary_auprc")
    port_fn = getattr(F, fn)
    args = (torch.from_numpy(s), torch.from_numpy(t))
    msg = explain_route(port_fn, *args)
    key = route_kernel(port_fn, *args)
    if want is None:
        assert "sort" in msg
        assert key == ("auc_from_sorted" if fn == "binary_auroc" else None)
    else:
        side, cap = want
        assert f"packed {side!r} side, cap {cap}" in msg
        assert key == ("rank_sum_counts" if fn == "binary_auroc" else "rank_hist_counts")
    kwargs = {"num_tasks": 2}
    assert _called(port_fn, *args, **kwargs) == ({key} if key else set())


@pytest.mark.parametrize("c, n", [(8, 256), (64, 2**14), (65, 2**14), (200, 2**17),
                                  (512, 4096), (1000, 2**17), (5000, 1024)])
def test_cm_route_matches_the_jax_decider(c, n):
    with _on_tpu():
        want = jcm._cm_route(c, n)
    if want == "matmul" and c > 64:
        # The JAX Pallas route starts at N = 2^15, a TPU timing; the
        # port's slab kernel takes every N, so only C <= 64 keeps the
        # matmul (PERF.md §7).
        want = "pallas"
    rng = np.random.default_rng(c)
    p = torch.from_numpy(rng.integers(0, c, n))
    y = torch.from_numpy(rng.integers(0, c, n))
    msg = explain_route(F.multiclass_confusion_matrix, p, y, num_classes=c)
    key = route_kernel(F.multiclass_confusion_matrix, p, y, num_classes=c)
    expected = {"matmul": None, "pallas": "confusion_slab", "scatter": None}[want]
    assert key == expected
    assert {"matmul": "one-hot products", "pallas": "confusion-slab kernel",
            "scatter": "scatter"}[want] in msg
    assert _called(F.multiclass_confusion_matrix, p, y, num_classes=c) == (
        {key} if key else set())
    trio = explain_route(F.multiclass_f1_score, p, y, num_classes=c, average="macro")
    assert "count trio" in trio
    assert route_kernel(F.multiclass_f1_score, p, y, num_classes=c, average="macro") == key


def test_cm_family_edge_explanations():
    p = torch.zeros(256, dtype=torch.int32)
    assert "micro" in explain_route(F.multiclass_f1_score, p, p)
    assert "not routable" in explain_route(F.multiclass_f1_score, p, p, average="bogus")
    assert "not routable" in explain_route(F.multiclass_precision, p, p, average="macro")
    assert "not routable" in explain_route(F.multiclass_confusion_matrix, p, p)


@pytest.mark.parametrize("fn, shape, threshold", [
    ("binary_binned_auroc", (4096,), 10_000),
    ("binary_binned_auprc", (3, 4096), 100),
    ("multiclass_binned_auroc", (4096, 5), 200),
    ("multilabel_binned_auprc", (4096, 5), 64),
])
def test_binned_route_matches_the_jax_decider(fn, shape, threshold):
    from torcheval_tpu.metrics.functional.classification.binned_auc import (
        _select_binned_route as jax_route,
    )

    port_fn = getattr(F, fn)
    kind = "binary" if fn.startswith("binary") else "classes"
    rows = (shape[0] if len(shape) == 2 else 1) if kind == "binary" else shape[1]
    n = shape[-1] if kind == "binary" else shape[0]
    with _on_tpu():
        want = jax_route(rows, n, jnp.zeros((threshold,), jnp.float32))
    # JAX's two device formulations (a fused compare for small work, the
    # Pallas kernel past it) are one kernel in the port.
    assert want in ("broadcast", "pallas")
    rng = np.random.default_rng(threshold)
    s = torch.from_numpy(rng.random(shape, dtype=np.float32))
    if kind == "binary":
        t = torch.from_numpy(rng.integers(0, 2, shape))
    elif fn.startswith("multilabel"):
        t = torch.from_numpy(rng.integers(0, 2, shape))
    else:
        t = torch.from_numpy(rng.integers(0, shape[1], shape[0]))
    kwargs = {"threshold": threshold}
    if fn == "binary_binned_auprc":
        kwargs["num_tasks"] = shape[0]
    if fn == "multiclass_binned_auroc":
        kwargs["num_classes"] = shape[1]
    if fn == "multilabel_binned_auprc":
        kwargs["num_labels"] = shape[1]
    msg = explain_route(port_fn, s, t, **kwargs)
    assert "binned-count kernel" in msg and route_kernel(port_fn, s, t, **kwargs) == "binned_counts"
    assert _called(port_fn, s, t, **kwargs) == {"binned_counts"}


def test_text_family_names_the_wavefront_kernel():
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.integers(0, 9, (6, 300)).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, 9, (6, 40)).astype(np.int32))
    for fn in (F.word_error_rate, F.word_information_preserved, F.word_information_lost,
               edit_distance_tokens):
        msg = explain_route(fn, h, r)
        assert "wavefront kernel" in msg and "three-way" in msg and "Geometry: 6 pairs" in msg
        assert route_kernel(fn, h, r) == "edit_distance_tokens"
        assert _called(fn, h, r) == {"edit_distance_tokens"}
    msg = explain_route(F.word_error_rate, ["a b c"], ["a c"])
    assert "host string path" in msg and route_kernel(F.word_error_rate, ["a"], ["a"]) is None


def test_fused_update_explanation(monkeypatch):
    col = MetricCollection({"acc": MulticlassAccuracy(num_classes=8, device="cpu"),
                            "cm": MulticlassConfusionMatrix(num_classes=8, device="cpu")})
    x, y = torch.rand(16, 8), torch.randint(0, 8, (16,))
    msg = explain_route(col.fused_update, x, y)
    assert "auto mode engages for states on a GPU" in msg
    assert route_kernel(col.fused_update, x, y) is None
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    assert "ENGAGED" in explain_route(col.fused_update, x, y)
    assert route_kernel(col.fused_update, x, y) == "mega_counts"
    assert _called(col.fused_update, x, y) == {"mega_counts"}
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "0")
    assert "OFF" in explain_route(col.fused_update, x, y)
    windowed = MetricCollection({"w": WindowedBinaryAUROC(max_num_samples=8, device="cpu")})
    assert "not fusable" in explain_route(windowed.fused_update, torch.rand(4), torch.ones(4))


def test_sharded_explanations_name_wire_and_kernel():
    from torcheval_tpu_torch.distributed import LocalWorld
    from torcheval_tpu_torch.parallel import make_mesh

    s = torch.rand(64)
    t = (torch.rand(64) > 0.5).to(torch.int32)

    def explain(group, rank):
        mesh = make_mesh(group=group)
        return [
            explain_route(P.sharded_binary_auroc_ustat, s, t, mesh),
            explain_route(P.sharded_binary_auroc_ustat, s, t, mesh, max_minority_count_per_shard=8),
            route_kernel(P.sharded_multiclass_auroc_ustat, s[:, None], t, mesh, num_classes=1),
            explain_route(P.sharded_multiclass_auroc_ustat, s[:, None], t, mesh),
            route_kernel(P.sharded_auroc_histogram, s, t, mesh, weights=torch.ones(64)),
            route_kernel(P.sharded_multiclass_auroc_histogram, s[:, None], t, mesh),
            explain_route(P.sharded_binary_auroc_exact, s, t, mesh),
        ]

    (out,) = {tuple(r) for r in LocalWorld(2).run(explain)}
    assert "packs its whole 64-sample block" in out[0] and "cap 8 per shard" in out[1]
    assert out[2] == "rank_sum_counts" and "not routable" in out[3]
    assert out[4] == "binned_weighted_counts" and out[5] == "binned_counts"
    assert "all-gather" in out[6]
    assert "no call-time routing" in explain_route(len, [1])


def test_warn_route_downgrade_warns_once_a_call_site_at_the_callers_line():
    def emit():
        warn_route_downgrade("k1", "message one")

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        emit()
        emit()  # the same call site inside emit: deduped
        warn_route_downgrade("k2", "message two")  # a new kind fires
        line = emit.__code__.co_firstlineno + 1
    assert [str(w.message) for w in rec] == ["message one", "message two"]
    assert all(w.category is RouteDowngradeWarning for w in rec)
    assert rec[0].filename == __file__ and rec[0].lineno == line
    reset_route_warnings()
    with warnings.catch_warnings(record=True) as again:
        warnings.simplefilter("always")
        emit()
    assert len(again) == 1


def test_downgrade_events_count_every_occurrence():
    from torcheval_tpu_torch import telemetry
    from tests.test_torch_telemetry import reset_all

    reset_all()
    telemetry.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for _ in range(3):
                warn_route_downgrade("k", "m")
        assert telemetry.report()["route_downgrades"] == {"total": 3, "by_kind": {"k": 3}}
    finally:
        reset_all()


def test_hot_path_stats_reads_captures_and_graph_caches():
    from torcheval_tpu_torch.engine import Evaluator

    _stats.reset_trace_count()
    col = MetricCollection({"acc": MulticlassAccuracy(num_classes=4, device="cpu")}, bucket=True)
    ev = Evaluator(col, block_size=2)
    rng = np.random.default_rng(0)
    batches = [(rng.random((8, 4), dtype=np.float32), rng.integers(0, 4, 8)) for _ in range(4)]
    ev.run(batches)
    stats = routing.hot_path_stats()
    assert stats["trace_counts"] == _stats.trace_counts() and sum(stats["trace_counts"].values()) == 1
    cache = stats["spmd_cache"]
    assert set(cache) == {"hits", "misses", "maxsize", "currsize", "peak_bytes"}
    assert cache["currsize"] >= 1 and cache["hits"] >= 1 and cache["misses"] >= 1
