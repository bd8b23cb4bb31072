"""The port's measured-cost layer (``torcheval_tpu_torch.routing_autotune``)
and ``aot.warmup(autotune=True)``, with cases from
``tests/test_routing_autotune.py``: the store's round trip and the
quarantine of a torn or tampered file, staleness (version, route-token
context, card), preference ranking and ``decide`` (held against the JAX
layer on the same cost tables), flag precedence, the race under a probe
budget, and the off layer's identity."""

import hashlib
import json
import os
from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest
import torch

from torcheval_tpu import routing_autotune as jra

from torcheval_tpu_torch import _flags, aot
from torcheval_tpu_torch import routing_autotune as ra
from torcheval_tpu_torch.metrics import (
    BinaryAUROC,
    MetricCollection,
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassConfusionMatrix,
)
from torcheval_tpu_torch.metrics.functional.classification import confusion_matrix as cm
from torcheval_tpu_torch.ops import _build, _mega_plan

_FLAGS = ("AUTOTUNE", "AUTOTUNE_DIR", "AUTOTUNE_PROBE_BUDGET", "MEGAKERNEL", "CM_ROW_CHUNK",
          "DISABLE_USTAT", "RANK_SKETCH")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for flag in _FLAGS:
        monkeypatch.delenv(_flags.PREFIX + flag, raising=False)
    ra.disable()
    ra.clear()
    yield
    ra.disable()
    ra.clear()


@contextmanager
def _layer(tmp=None, **env):
    """The layer on against a private store (``tmp``), with extra port flags."""
    overrides = {_flags.PREFIX + k: v for k, v in env.items()}
    if tmp is not None:
        overrides[_flags.PREFIX + "AUTOTUNE_DIR"] = str(tmp)
    with mock.patch.dict(os.environ, overrides):
        ra.clear()
        ra.enable()
        try:
            yield
        finally:
            ra.disable()
            ra.clear()


def _seed_pair(decision="megakernel", signature="sigA", fast="mega", slow="fused",
               fast_s=1e-3, slow_s=3e-3, site="race", layer=ra):
    layer.record_measurement(decision, fast, signature, fast_s, site=site)
    layer.record_measurement(decision, slow, signature, slow_s, site=site)


def test_flush_reload_round_trip_with_sidecar(tmp_path):
    with _layer(tmp_path):
        _seed_pair()
        path = ra.flush()
        assert path == os.path.join(tmp_path, "torcheval_tpu_torch_route_costs.json")
        assert os.path.exists(path + ".sha256") and ra.flush() is None  # nothing new
        ra.clear()
        rows = ra.store_rows()
        from torcheval_tpu_torch.version import __version__

        assert len(rows) == 2
        for row in rows:
            assert row["version"] == __version__ and row["device_kind"] == "cpu"
            assert (row["site"], row["kind"]) == ("race", "measured")
            assert len(row["token"]) == 4 and row["token"][0] == "*"  # the decided flag
            assert row["choice"] in ("mega", "fused")


def test_without_a_directory_the_store_lives_in_memory():
    with _layer(None):
        _seed_pair()
        assert ra.flush() is None and ra.store_path() is None
        assert ra.preference("megakernel", "sigA") is not None


@pytest.mark.parametrize("damage", ["torn", "sidecar", "unparseable"])
def test_a_corrupt_store_is_quarantined(tmp_path, damage):
    with _layer(tmp_path):
        path = os.path.join(tmp_path, "torcheval_tpu_torch_route_costs.json")
        if damage == "unparseable":
            payload = b"{not json"
            with open(path, "wb") as fh:
                fh.write(payload)
            with open(path + ".sha256", "w", encoding="utf-8") as fh:
                fh.write(hashlib.sha256(payload).hexdigest() + "\n")
        else:
            _seed_pair()
            ra.flush()
            if damage == "torn":
                with open(path, "ab") as fh:
                    fh.write(b"torn")
            else:
                with open(path + ".sha256", "w", encoding="utf-8") as fh:
                    fh.write("0" * 64 + "\n")
            ra.clear()
        assert ra.store_rows() == []
        assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
        assert os.path.exists(path + ".sha256.corrupt")


def test_rows_of_another_version_are_dropped_not_quarantined(tmp_path):
    with _layer(tmp_path):
        _seed_pair()
        path = ra.flush()
        with open(path, "rb") as fh:
            doc = json.loads(fh.read())
        for row in doc["rows"].values():
            row["version"] = "0.0.0"
        payload = json.dumps(doc, sort_keys=True).encode("utf-8")
        with open(path, "wb") as fh:
            fh.write(payload)
        with open(path + ".sha256", "w", encoding="utf-8") as fh:
            fh.write(hashlib.sha256(payload).hexdigest() + "\n")
        ra.clear()
        assert ra.store_rows() == [] and os.path.exists(path)


def test_decisions_and_their_absent_counterpart():
    assert ra.DECISIONS == ("megakernel", "rank_sketch", "cm_row_chunk")
    # The JAX layer's wavefront decision has no counterpart in the port.
    assert set(jra.DECISIONS) - set(ra.DECISIONS) == {"wavefront"}
    with _layer():
        with pytest.raises(ValueError, match="unknown decision"):
            ra.record_measurement("wavefront", "pallas", "sigA", 1e-3)


_TABLES = [
    [("mega", 1e-3, "race"), ("fused", 2e-3, "race")],
    [("mega", 5e-3, "race"), ("fused", 2e-3, "race")],
    [("mega", 1e-3, "race"), ("fused", 1e-3, "race")],
    [("mega", 1e-3, "race")],  # one-sided: cannot rank
    [("mega", 1e-3, "race"), ("fused", 2e-3, "collection")],  # sites never mixed
    [("mega", 1e-4, "collection"), ("fused", 2e-4, "collection"),
     ("fused", 1e-3, "race"), ("mega", 2e-3, "race")],  # the race outranks pricing
]


@pytest.mark.parametrize("table", range(len(_TABLES)))
def test_preference_and_decide_equal_jax_on_the_same_costs(table):
    with _layer(), mock.patch.dict(os.environ, {"TORCHEVAL_TPU_AUTOTUNE": "1"}):
        jra.clear()
        jra.enable()
        try:
            for layer in (ra, jra):
                for choice, seconds, site in _TABLES[table]:
                    layer.record_measurement("megakernel", choice, "sigA", seconds, site=site)
            want, got = jra.preference("megakernel", "sigA"), ra.preference("megakernel", "sigA")
            assert got == want
            for default in ("mega", "fused"):
                assert ra.decide("megakernel", "sigA", default) == jra.decide(
                    "megakernel", "sigA", default)
        finally:
            jra.disable()
            jra.clear()


def test_staleness_never_binds(monkeypatch):
    with _layer():
        _seed_pair()
        assert ra.preference("megakernel", "sigA") is not None
        with mock.patch.object(ra, "_device_kind", return_value="NVIDIA H100 80GB HBM3"):
            assert ra.preference("megakernel", "sigA") is None  # another card
        # A context flag the megakernel stamp does not mask: drift unbinds.
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "1")
        assert ra.preference("megakernel", "sigA") is None
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT")
        assert ra.preference("megakernel", "sigA") is not None


def test_the_decided_flag_is_masked_and_an_explicit_flag_outranks_the_pick(monkeypatch):
    with _layer():
        _seed_pair("cm_row_chunk", "*", "2048", "4096")
        assert cm._cm_row_chunk() == 2048 and ra.decide("cm_row_chunk", "*", "4096") == "2048"
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK", "8192")
        # Masked: forcing the decided flag keeps the rows binding ...
        assert ra.preference("cm_row_chunk", "*")["choice"] == "2048"
        # ... and the explicit flag wins over them.
        assert cm._cm_row_chunk() == 8192 and ra.decide("cm_row_chunk", "*", "4096") == "8192"
        _seed_pair("megakernel", "sigB", "fused", "mega")
        assert ra.decide("megakernel", "sigB", "mega") == "fused"
        for raw, want in (("1", "mega"), ("0", "fused")):
            monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raw)
            assert ra.decide("megakernel", "sigB", "fused") == want
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_RANK_SKETCH", "1")
        assert ra.decide("rank_sketch", "sigC", "sort") == "sketch"


def test_plan_for_auto_mode_follows_the_measured_pick():
    col = MetricCollection({"acc": MulticlassAccuracy(num_classes=4, device="cpu"),
                            "cm": MulticlassConfusionMatrix(num_classes=4, device="cpu")})
    args = (torch.rand(16, 4), torch.randint(0, 4, (16,)))
    assert _mega_plan.plan_for(col._metrics, args, {}, None) is None  # auto: CPU declines
    with _layer():
        with _flags.overridden("MEGAKERNEL", "1"):
            members = _mega_plan.plan_for(col._metrics, args, {}, None).members
        sig = _mega_plan.plan_signature(args, members)
        assert sig.startswith(ra.batch_signature(args) + "-")
        _seed_pair("megakernel", sig, "mega", "fused")
        assert _mega_plan.plan_for(col._metrics, args, {}, None) is not None
        ra.record_measurement("megakernel", "fused", sig, 1e-4)  # a faster fused row lands
        assert _mega_plan.plan_for(col._metrics, args, {}, None) is None


def test_route_token_carries_the_epoch_only_while_enabled():
    static = _mega_plan.route_token()
    assert len(static) == 4
    with _layer():
        token = _mega_plan.route_token()
        assert token[:4] == static and token[4] == ra.EPOCH
        ra.record_measurement("megakernel", "mega", "s", 1e-3)
        assert _mega_plan.route_token()[4] == token[4] + 1
    assert _mega_plan.route_token() == static


def test_measured_crossover_and_signature():
    with _layer():
        _seed_pair(signature="small", fast_s=1e-3, slow_s=2e-3)
        _seed_pair(signature="wide", fast_s=1e-3, slow_s=9e-3)
        cross = ra.measured_crossover("megakernel")
        assert cross["signature"] == "wide" and cross["choice"] == "mega"
        assert ra.measured_crossover("cm_row_chunk") is None
    a = np.zeros((8, 4), np.float32)
    assert ra.batch_signature((torch.from_numpy(a),)) == jra.batch_signature((a,))
    assert ra.batch_signature((torch.ones(8, 4),)) == ra.batch_signature((torch.zeros(8, 4),))
    assert ra.batch_signature((torch.zeros(8, 4),)) != ra.batch_signature(
        (torch.zeros(8, 4, dtype=torch.float64),))
    assert ra.batch_signature((torch.zeros(8, 4),)) != ra.batch_signature((torch.zeros(4, 4),))


def test_observe_profile_prices_rows_from_the_roofline():
    with _layer():
        ra.observe_profile("mega_scan", (torch.zeros(3, 16, 4),), {"bytes_accessed": 5e10,
                                                                    "flops": 1.0})
        ra.observe_profile("unknown_program", (torch.zeros(3),), {"bytes_accessed": 1.0})
        (row,) = ra.store_rows()
        assert (row["site"], row["kind"], row["choice"]) == ("scan", "priced", "mega")
        assert row["seconds"] == pytest.approx(5e10 / 50e9)  # the CPU fallback's 50 GB/s
        assert row["signature"] == ra.batch_signature((torch.zeros(16, 4),))


def test_flags_resolve_and_are_listed(monkeypatch, tmp_path):
    assert ra.probe_budget() == 8
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_AUTOTUNE_PROBE_BUDGET", "3")
    assert ra.probe_budget() == 3
    for bad in ("0", "-1", "many"):
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_AUTOTUNE_PROBE_BUDGET", bad)
        with pytest.raises(ValueError, match="AUTOTUNE_PROBE_BUDGET must be a positive"):
            ra.probe_budget()
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_AUTOTUNE_PROBE_BUDGET")
    assert ra._resolve_enabled() is False
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_AUTOTUNE_DIR", str(tmp_path))
    assert ra._resolve_enabled() is True  # auto: on with a directory
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_AUTOTUNE", "0")
    assert ra._resolve_enabled() is False
    snap = _flags.snapshot_non_default()
    assert snap["TORCHEVAL_TPU_TORCH_AUTOTUNE"] is False
    assert snap["TORCHEVAL_TPU_TORCH_AUTOTUNE_DIR"] == str(tmp_path)
    with _flags.overridden("AUTOTUNE", "1"):
        assert ra._resolve_enabled() is True
    assert os.environ["TORCHEVAL_TPU_TORCH_AUTOTUNE"] == "0"
    with pytest.raises(KeyError):
        with _flags.overridden("WAVEFRONT", "1"):
            pass


def _small_collection(c=8, bucket=False):
    return MetricCollection({"acc": MulticlassAccuracy(num_classes=c, device="cpu"),
                             "cm": MulticlassConfusionMatrix(num_classes=c, device="cpu")},
                            bucket=bucket)


def _small_batch(c=8, n=16, seed=7):
    rng = np.random.default_rng(seed)
    return rng.random((n, c), dtype=np.float32), rng.integers(0, c, n).astype(np.int32)


def test_race_records_rows_skips_measured_shapes_and_restores_states(tmp_path):
    with _layer(tmp_path):
        col = _small_collection()
        batch = _small_batch()
        col.update(*batch)
        before = {k: v.clone() for k, v in col.state_dict().items()}
        _build.reset_counts()
        aot.warmup(col, batch, autotune=True)
        assert all(torch.equal(before[k], v) for k, v in col.state_dict().items())
        rows = [r for r in ra.store_rows() if r["site"] == "race"]
        assert {r["decision"] for r in rows} == {"megakernel", "cm_row_chunk"}
        for decision in ("megakernel", "cm_row_chunk"):
            assert len([r for r in rows if r["decision"] == decision]) == 2
        assert {r["choice"] for r in rows if r["decision"] == "cm_row_chunk"} == {"4096", "8192"}
        assert os.path.exists(ra.store_path())  # persisted without a flush call
        # The mega candidate ran the kernel's plain version on these CPU states.
        assert _build.PLAIN_CALLS["mega_counts"] >= 3 and not _build.LAUNCHES
        stamps = {(r["decision"], r["choice"]): r["updated"] for r in rows}
        aot.warmup(_small_collection(), batch, autotune=True)
        assert stamps == {(r["decision"], r["choice"]): r["updated"]
                          for r in ra.store_rows() if r["site"] == "race"}


def test_race_under_a_budget_of_one_races_nothing(tmp_path):
    with _layer(tmp_path, AUTOTUNE_PROBE_BUDGET="1"):
        aot.warmup(_small_collection(), _small_batch(), autotune=True)
        assert ra.store_rows() == []


def test_explicit_kill_switch_outranks_the_argument(tmp_path):
    with _layer(tmp_path, AUTOTUNE="0"):
        aot.warmup(_small_collection(), _small_batch(), autotune=True)
        assert ra.store_rows() == []


def test_warmup_turns_the_layer_on_and_races_a_bucketed_collection():
    assert not ra.ENABLED
    aot.warmup(_small_collection(bucket=True), _small_batch(n=13), autotune=True)
    assert ra.ENABLED
    sig = {r["signature"] for r in ra.store_rows() if r["decision"] == "megakernel"}
    # The pick keys on the batch fused_update's plan sees (padded to its
    # bucket) and on the plan's members.
    col = _small_collection(bucket=True)
    padded = col._prepare(tuple(torch.from_numpy(a) for a in _small_batch(n=128)), {})[0]
    with _flags.overridden("MEGAKERNEL", "1"):
        members = _mega_plan.plan_for(col._metrics, padded, {}, None).members
    assert sig == {_mega_plan.plan_signature(padded, members)}


def test_collections_of_other_members_on_the_same_batch_race_apart(tmp_path):
    # The JAX store keys the collection-kernel decision on the batch alone;
    # the port adds the plan's members, so C = 4 and C = 8 race apart.
    with _layer(tmp_path):
        batch = (np.random.default_rng(1).integers(0, 4, 64).astype(np.int32),) * 2
        aot.warmup(_small_collection(c=8), batch, autotune=True)
        aot.warmup(_small_collection(c=4), batch, autotune=True)
        sigs = {r["signature"] for r in ra.store_rows() if r["decision"] == "megakernel"}
        assert len(sigs) == 2 and len({s.split("-")[0] for s in sigs}) == 1


def test_explain_route_names_the_measured_numbers(tmp_path):
    from torcheval_tpu_torch.routing import explain_route

    col = _small_collection()
    batch = tuple(torch.from_numpy(a) for a in _small_batch())
    assert "Measured verdict" not in explain_route(col.fused_update, *batch)
    with _layer(tmp_path):
        assert "no binding cost-store rows" in explain_route(col.fused_update, *batch)
        aot.warmup(col, batch, autotune=True)
        msg = explain_route(col.fused_update, *batch)
        assert "Measured verdict: " in msg and "race site" in msg
        with mock.patch.dict(os.environ, {"TORCHEVAL_TPU_TORCH_MEGAKERNEL": "1"}):
            assert "an explicit flag pins mega" in explain_route(col.fused_update, *batch)


def test_context_drift_reprobes(tmp_path, monkeypatch):
    with _layer(tmp_path):
        batch = _small_batch()
        aot.warmup(_small_collection(), batch, autotune=True)
        stamps = {r["choice"]: r["updated"] for r in ra.store_rows()
                  if r["decision"] == "cm_row_chunk"}
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "1")
        aot.warmup(_small_collection(), batch, autotune=True)
        rows = [r for r in ra.store_rows() if r["decision"] == "cm_row_chunk"
                and r["token"][2] == "True"]
        assert len(rows) == 2 and all(r["updated"] > stamps[r["choice"]] for r in rows)


@pytest.mark.parametrize("make", [
    lambda: BinaryAUROC(device="cpu"),
    lambda: MulticlassAUROC(num_classes=4, device="cpu"),
])
def test_sketch_race_is_advice_on_fresh_twins(tmp_path, make):
    with _layer(tmp_path):
        metric = make()
        rng = np.random.default_rng(3)
        if isinstance(metric, BinaryAUROC):
            batch = (rng.random(64).astype(np.float32), rng.integers(0, 2, 64))
        else:
            batch = (rng.random((64, 4)).astype(np.float32), rng.integers(0, 4, 64))
        aot.warmup(metric, batch, autotune=True)
        rows = ra.store_rows()
        assert {(r["decision"], r["choice"]) for r in rows} == {
            ("rank_sketch", "sketch"), ("rank_sketch", "sort")}
        # Advice only: the metric keeps its exact layout and empty states.
        assert not metric._sketch_mode and all(
            v.numel() == 0 for v in metric.state_dict().values() if isinstance(v, torch.Tensor))


def test_off_layer_keeps_routes_and_counts_identical():
    col, ref = _small_collection(), _small_collection()
    batch = tuple(torch.from_numpy(a) for a in _small_batch(n=64))
    with mock.patch.dict(os.environ, {"TORCHEVAL_TPU_TORCH_MEGAKERNEL": "1"}):
        _build.reset_counts()
        col.fused_update(*batch)
        counts = dict(_build.PLAIN_CALLS)
        ref.fused_update(*batch)
    assert counts == {"mega_counts": 1} and not ra.ENABLED and ra.store_rows() == []
    assert all(torch.equal(v, ref.state_dict()[k]) for k, v in col.state_dict().items())


def test_the_explicit_row_chunk_pin_reads_through_the_registry(monkeypatch):
    # The explicit CM_ROW_CHUNK pin reads the flag through _flags.raw, the
    # registry's own reader, not os.environ directly (the static half of
    # this pin is tests/test_torch_analysis.py's TPU013 mutation).
    assert _flags.raw("CM_ROW_CHUNK") is None and ra._explicit("cm_row_chunk") is None
    monkeypatch.setenv(_flags.PREFIX + "CM_ROW_CHUNK", "  ")
    assert _flags.raw("CM_ROW_CHUNK") == "  " and ra._explicit("cm_row_chunk") is None
    monkeypatch.setenv(_flags.PREFIX + "CM_ROW_CHUNK", "8192")
    assert _flags.raw("CM_ROW_CHUNK") == "8192" and ra._explicit("cm_row_chunk") == "8192"
    with pytest.raises(KeyError):
        _flags.raw("NO_SUCH_FLAG")


def test_a_race_with_the_layer_off_records_nothing(tmp_path):
    # The race records a measurement only under routing_autotune.ENABLED,
    # as the JAX package's race does; with enable() unable to turn the
    # layer on, the candidates still run and no row is written.
    with mock.patch.dict(os.environ, {_flags.PREFIX + "AUTOTUNE_DIR": str(tmp_path)}):
        with mock.patch.object(ra, "enable", lambda: None):
            assert not ra.ENABLED
            aot.warmup(_small_collection(), _small_batch(), autotune=True)
        assert ra.store_rows() == []
