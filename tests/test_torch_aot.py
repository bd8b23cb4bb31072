"""The port's ``aot.warmup``, capture counter (``_stats``), program cache
(``parallel/_compile_cache.py``), quality exporter (``monitor/``) and the
launch recorder the engine's graphs count with, against the JAX package
where it has the same function.  Everything on the CPU, at small sizes."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.aot as jax_aot
import torcheval_tpu.metrics as jm
from torcheval_tpu.monitor import quality as jax_quality
from torcheval_tpu.telemetry import events as jax_events

import torcheval_tpu_torch.metrics as tm
from torcheval_tpu_torch import _stats, aot, monitor
from torcheval_tpu_torch.ops import _build, _mega_plan
from torcheval_tpu_torch.parallel._compile_cache import LruCache, SpmdCacheInfo
from torcheval_tpu_torch.telemetry import events as port_events

from tests.test_torch_telemetry import reset_all

C = 5


@pytest.fixture(autouse=True)
def _isolated():
    reset_all()
    yield
    reset_all()


def _col(bucket=True, slices=None):
    return tm.MetricCollection(
        {"acc": tm.MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),
         "cm": tm.MulticlassConfusionMatrix(num_classes=C, device="cpu")},
        bucket=bucket, slices=slices)


def _jax_col(bucket=True, slices=None):
    return jm.MetricCollection(
        {"acc": jm.MulticlassAccuracy(num_classes=C, average="macro"),
         "cm": jm.MulticlassConfusionMatrix(num_classes=C)},
        bucket=bucket, donate=False, slices=slices)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, C), dtype=np.float32), rng.integers(0, C, n).astype(np.int32)


# ------------------------------------------------------------------ warmup
@pytest.mark.parametrize(
    "kwargs",
    [{"max_batch": 600}, {}, {"sizes": (128, 512)}, {"max_batch": 600, "fused": False}],
    ids=["max-batch", "example-size", "explicit-sizes", "plain-update"],
)
def test_collection_warmup_sweeps_as_jax_and_is_state_invisible(kwargs):
    x, y = _batch(100)
    col = _col()
    col.fused_update(torch.from_numpy(x[:7]), torch.from_numpy(y[:7]))
    before = {k: v.clone() for k, v in col.state_dict().items()}
    sweep = aot.warmup(col, (x, y), **kwargs)
    assert sweep == jax_aot.warmup(_jax_col(), (jnp.asarray(x), jnp.asarray(y)), **kwargs)
    after = col.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_metric_warmup_takes_update_and_restores():
    x, y = _batch(64, seed=1)
    m = tm.MulticlassConfusionMatrix(num_classes=C, device="cpu")
    assert aot.warmup(m, (torch.from_numpy(x), torch.from_numpy(y)), max_batch=200) == (200,)
    assert int(m.confusion_matrix.sum()) == 0


def test_tile_to_cycles_real_rows():
    a = np.arange(6).reshape(3, 2)
    assert np.array_equal(aot._tile_to(a, 7), np.concatenate([a, a, a])[:7])
    t = torch.arange(3)
    assert torch.equal(aot._tile_to(t, 5), torch.tensor([0, 1, 2, 0, 1]))
    assert aot._tile_to(t, 3) is t


def test_autotune_waits_for_routing_autotune(monkeypatch):
    # routing_autotune is ported: autotune=True races the collection
    # kernel and the one-hot row height instead of raising, and leaves
    # the states as they were.
    from torcheval_tpu_torch import routing_autotune as ra

    for flag in ("AUTOTUNE", "AUTOTUNE_DIR", "MEGAKERNEL", "CM_ROW_CHUNK"):
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_" + flag, raising=False)
    ra.clear()
    try:
        col = _col()
        col.update(*_batch(8))
        before = {k: v.clone() for k, v in col.state_dict().items()}
        assert aot.warmup(col, _batch(8), autotune=True) == (128,)
        assert all(torch.equal(before[k], v) for k, v in col.state_dict().items())
        assert ra.ENABLED
        assert {(r["decision"], r["site"]) for r in ra.store_rows()} == {
            ("megakernel", "race"), ("cm_row_chunk", "race")}
    finally:
        ra.disable()
        ra.clear()


def test_empty_example_raises():
    with pytest.raises(ValueError, match="at least one array"):
        aot.warmup(_col(), ())


def test_aot_exports_the_jax_names():
    assert aot.__all__ == jax_aot.__all__
    assert aot.bucket_sizes(600) == jax_aot.bucket_sizes(600)


# ----------------------------------------------------------- capture counter
def test_capture_counter_counts_resets_and_loses_no_bump():
    _stats.reset_trace_count()
    port_events.enable()

    def bump():
        for _ in range(500):
            _stats.bump_trace("mega_scan")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _stats.bump_trace("engine_scan")
    assert aot.trace_count("mega_scan") == 2000 and aot.trace_count() == 2001
    assert aot.trace_counts() == {"mega_scan": 2000, "engine_scan": 1}
    assert len(port_events.events("retrace")) == 2001
    aot.reset_trace_count()
    assert aot.trace_count() == 0 and aot.trace_counts() == {}


# -------------------------------------------------------------- LRU cache
def test_lru_cache_capacity_eviction_and_counters(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_COMPILE_CACHE_CAP", "2")
    cache = LruCache(name="t", telemetry_events=True)
    assert cache.capacity == 2
    port_events.enable()
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1  # a is now the most recent
    cache.put("c", 3)  # evicts b
    assert "b" not in cache and "a" in cache and len(cache) == 2
    assert cache.get("b") is None
    assert cache.get_or_create("d", lambda: 4) == 4 and cache.get_or_create("d", lambda: 5) == 4
    info = cache.cache_info()
    assert isinstance(info, SpmdCacheInfo)
    assert (info.hits, info.misses, info.maxsize, info.currsize, info.evictions) == (2, 2, 2, 2, 2)
    assert port_events.aggregates()["cache"]["evictions"] == 2
    cache.clear()
    assert len(cache) == 0 and cache.cache_info().hits == 0


@pytest.mark.parametrize("raw, want", [(None, 256), ("8", 8), ("0", 256), ("x", 256)])
def test_lru_cache_capacity_flag(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_COMPILE_CACHE_CAP", raising=False)
    else:
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_COMPILE_CACHE_CAP", raw)
    assert LruCache().capacity == want
    assert LruCache(capacity=3).capacity == 3


# -------------------------------------------------------- launch recorder
def test_a_capture_records_launches_and_a_replay_counts_them():
    _build.reset_counts()
    with _build.recording() as recorded:
        _build.count_launch("mega_counts")
        _build.count_launch("mega_counts")
        _build.count_launch("confusion_slab")
    assert not _build.LAUNCHES
    assert dict(recorded) == {"mega_counts": 2, "confusion_slab": 1}
    _build.count_replay(recorded)
    _build.count_replay(recorded)
    assert dict(_build.LAUNCHES) == {"mega_counts": 4, "confusion_slab": 2}
    _build.count_launch("mega_counts")
    assert _build.LAUNCHES["mega_counts"] == 5
    _build.reset_counts()


def test_route_token_follows_the_flags(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raising=False)
    base = _mega_plan.route_token()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "0")
    assert _mega_plan.route_token() != base
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK", "256")
    assert _mega_plan.route_token()[1] == 256


# ----------------------------------------------------------------- monitor
def test_publish_emits_the_jax_quality_events():
    rng = np.random.default_rng(3)
    x = rng.random((300, C), dtype=np.float32)
    y = rng.integers(0, C, 300).astype(np.int32)
    ids = rng.integers(0, 2, 300).astype(np.int32)
    col = _col(slices=2)
    col.fused_update(torch.from_numpy(x), torch.from_numpy(y), slice_ids=torch.from_numpy(ids))
    jcol = _jax_col(slices=2)
    jcol.fused_update(jnp.asarray(x), jnp.asarray(y), slice_ids=jnp.asarray(ids))
    port_events.enable()
    jax_events.enable()
    assert monitor.publish(col, step=3) == jax_quality.publish(jcol, step=3) == 3

    def rows(events):
        return [(e.metric, e.slice_label, e.window, e.step, e.value)
                for e in events.events("quality")]

    got, want = rows(port_events), rows(jax_events)
    assert [r[:4] for r in got] == [r[:4] for r in want]
    np.testing.assert_allclose([r[4] for r in got], [r[4] for r in want], rtol=1e-6)
    assert monitor.window_kind(col["acc"]) == jax_quality.window_kind(jcol["acc"]) == "lifetime"
    # The monitor's names are the JAX package's since the wrappers came.
    import torcheval_tpu.monitor as jax_monitor

    assert monitor.__all__ == jax_monitor.__all__
