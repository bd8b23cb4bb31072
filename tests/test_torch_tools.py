"""The port's ``tools/`` (``torcheval_tpu_torch.tools``) against the JAX
package's: the roofline arithmetic on the same peaks and bytes, FLOP
counts of pure products, the flagship MLP's parameter summary and product
FLOPs (weights through ``convert.params_from_jax``), and
``ProfiledMetric``'s call and state-byte accounting around the same
metric on the same numpy inputs (seeded)."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
from torcheval_tpu import tools as jtools
from torcheval_tpu.tools import roofline as jroofline

import torcheval_tpu_torch.metrics as tm
from torcheval_tpu_torch import convert, tools
from torcheval_tpu_torch.flagship import FlagshipMLP
from torcheval_tpu_torch.tools import profiling, roofline


def test_peak_table_holds_the_h100_and_the_cpu_fallback_only():
    assert roofline.known_device_kinds() == ("NVIDIA H100 80GB HBM3", "cpu")
    h100 = roofline.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"device_kind": "NVIDIA H100 80GB HBM3", "hbm_gbps": 3350.0,
                    "flops": 989.4e12, "exact": True}
    # No TPU row: an unknown kind (a TPU's included) reads the CPU fallback.
    other = roofline.device_peaks("TPU v5e")
    assert not other["exact"] and other["hbm_gbps"] == 50.0 and other["flops"] == 5e11
    assert roofline.current_device_kind() == "cpu"  # no GPU in this test run
    assert roofline.device_peaks()["device_kind"] == "cpu"


def test_register_device_peaks_validates_and_overrides(monkeypatch):
    monkeypatch.setattr(roofline, "_DEVICE_PEAKS", dict(roofline._DEVICE_PEAKS))
    with pytest.raises(ValueError, match="peaks must be positive"):
        roofline.register_device_peaks("card", hbm_gbps=0.0, flops=1.0)
    roofline.register_device_peaks("card", hbm_gbps=1000.0, flops=2e12)
    assert roofline.device_peaks("card") == {
        "device_kind": "card", "hbm_gbps": 1000.0, "flops": 2e12, "exact": True}


@pytest.mark.parametrize(
    "flops, nbytes, seconds",
    [(0.0, 1e9, 1e-3), (4.2e9, 3.1e8, 2.5e-4), (1e15, 1.0, 1.0), (7.0, 9.0, 0.0)],
)
def test_roofline_arithmetic_equals_jax(flops, nbytes, seconds):
    peaks = roofline.device_peaks("NVIDIA H100 80GB HBM3")
    port = roofline.roofline(flops=flops, bytes_accessed=nbytes, seconds=seconds, peaks=peaks)
    ref = jroofline.roofline(flops=flops, bytes_accessed=nbytes, seconds=seconds, peaks=peaks)
    assert port == ref
    for batch in (0.0, 1e6, 3.3e7):
        assert roofline.reread_multiplier(nbytes, batch) == jroofline.reread_multiplier(
            nbytes, batch)


@pytest.mark.parametrize("m, k, n", [(1024, 32, 64), (7, 5, 3), (128, 256, 64), (16, 8, 4)])
def test_flops_of_products_equals_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = rng.random((m, k), np.float32), rng.random((k, n), np.float32)
    want = jtools.flops_of(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert want == 2 * m * k * n
    assert tools.flops_of(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b)) == want
    # meta tensors count the same without computing
    meta = (torch.empty(m, k, device="meta"), torch.empty(k, n, device="meta"))
    assert tools.flops_of(lambda x, y: x @ y, *meta) == want
    summary = tools.cost_summary(lambda x, y: x @ y, *meta)
    assert summary["flops"] == want and sum(summary["by_op"].values()) == want


def _flagship():
    import __graft_entry__ as graft

    _, (params, x, target) = graft.entry()
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return graft, params, np_params, np.array(x)


def test_flagship_params_summary_equals_jax():
    graft, params, np_params, x = _flagship()
    ref = jtools.get_params_summary(params, apply_fn=graft._forward, example_args=(jnp.asarray(x),))
    model = FlagshipMLP(device="cpu")
    state = convert.params_from_jax(np_params)
    model.load_state_dict(state)
    got = tools.get_params_summary(
        state,
        apply_fn=lambda p, inp: torch.func.functional_call(model, p, (inp,)),
        example_args=(torch.from_numpy(x),),
    )
    assert (got.num_parameters, got.num_trainable_parameters, got.size_bytes) == (
        ref.num_parameters, ref.num_trainable_parameters, ref.size_bytes) == (2632, 2632, 10528)
    # XLA counts one FLOP an element for the two bias adds and the ReLU;
    # FlopCounterMode counts the two products only.
    n, hidden, classes = x.shape[0], 64, 8
    elementwise = n * hidden + n * hidden + n * classes
    assert got.flops_forward == ref.flops_forward - elementwise == 2 * n * (32 * hidden + hidden * classes)
    assert got.flops_backward > 0 and got.peak_memory_bytes == -1  # no card here
    # The module walk agrees with the mapping walk on the root.
    walked = tools.get_module_summary(model, (torch.from_numpy(x),))
    assert (walked.num_parameters, walked.size_bytes, walked.flops_forward) == (
        got.num_parameters, got.size_bytes, got.flops_forward)
    assert list(walked.submodule_summaries) == ["fc1", "fc2"]
    assert walked.submodule_summaries["fc1"].flops_forward == 2 * n * 32 * hidden
    # Backward of a leaf Linear: the weight gradient only (its input needs
    # no gradient); of the root: both weight gradients and one input gradient.
    assert walked.submodule_summaries["fc2"].flops_backward == 2 * n * hidden * classes
    assert walked.flops_backward == 2 * n * (32 * hidden + 2 * hidden * classes)


def test_summary_table_and_pruning_match_jax_rendering():
    model = FlagshipMLP(device="cpu")
    summary = tools.get_module_summary(model, (torch.zeros(16, 32),))
    table = tools.get_summary_table(summary)
    assert table.splitlines()[0].split(" | ")[:3] == ["Name", "Type       ", "# Parameters"]
    assert "FlopCounterMode" in table and "fc1" in table
    assert "Peak Memory" not in table  # unknown on the CPU
    tools.prune_module_summary(summary, max_depth=1)
    assert summary.submodule_summaries == {}
    with pytest.raises(ValueError, match="max_depth"):
        tools.prune_module_summary(summary, max_depth=0)
    from torcheval_tpu.tools.module_summary import _get_human_readable_count as jcount
    from torcheval_tpu_torch.tools.module_summary import _get_human_readable_count as pcount

    for value in (0, 7, 999, 1000, 2632, 99_999, 123_456_789, 10**15):
        assert pcount(value) == jcount(value)
    no_flops = tools.get_module_summary(model, compute_flops=False)
    assert no_flops.flops_forward == -1 and "Forward FLOPs" not in str(no_flops)


def test_peak_memory_and_memory_profile_need_a_card():
    with pytest.raises(RuntimeError, match="no argument is on a GPU"):
        tools.peak_memory_of(lambda x: x * 2, torch.ones(4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            profiling.device_memory_profile()


def test_trace_annotate_and_device_seconds_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("phase.update"), profiling.step_marker("eval", 3):
            (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"phase.update", "eval#3"} <= names
    (path,) = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    with open(path) as fh:
        assert "traceEvents" in json.load(fh)
    seconds = profiling.device_seconds(lambda a, i: a @ a, (x,), iters=2, reps=1, max_iters=16)
    assert 0.0 < seconds < 1.0


_PROFILED = {
    # name: (JAX metric, port metric on the CPU, binary inputs)
    "accuracy": (lambda: jm.MulticlassAccuracy(num_classes=5, average="macro"),
                 lambda: tm.MulticlassAccuracy(num_classes=5, average="macro", device="cpu"),
                 False),
    "confusion": (lambda: jm.MulticlassConfusionMatrix(num_classes=5),
                  lambda: tm.MulticlassConfusionMatrix(num_classes=5, device="cpu"), False),
    "auroc": (jm.BinaryAUROC, lambda: tm.BinaryAUROC(device="cpu"), True),
}


@pytest.mark.parametrize("case", sorted(_PROFILED))
def test_profiled_metric_counts_calls_and_state_bytes_as_jax(case):
    make_jax, make_port, binary = _PROFILED[case]
    rng = np.random.default_rng(11)
    batches = [
        (rng.random(32).astype(np.float32), rng.integers(0, 2, 32).astype(np.int32))
        if binary else
        (rng.random((32, 5)).astype(np.float32), rng.integers(0, 5, 32).astype(np.int32))
        for _ in range(3)
    ]
    port = tools.ProfiledMetric(make_port())
    ref = jtools.ProfiledMetric(make_jax())
    assert isinstance(port, tm.Metric)
    for pm, conv in ((port, torch.from_numpy), (ref, jnp.asarray)):
        for inp, tgt in batches:
            assert pm.update(conv(inp), conv(tgt)) is pm
    assert port.state_bytes() == ref.state_bytes() > 0
    for pm in (port, ref):
        pm.compute()
        pm.merge_state([pm])
    assert port.state_bytes() == ref.state_bytes()
    for pm in (port, ref):
        pm.reset()
    assert port.state_bytes() == ref.state_bytes()
    got, want = port.report(), ref.report()
    for phase in ("update", "compute", "merge_state", "reset"):
        assert got[phase]["calls"] == want[phase]["calls"]
    assert got["state_bytes"] == want["state_bytes"] and got["name"] == want["name"]
    table = tools.profile_summary_table([port])
    assert table.splitlines()[0] == jtools.profile_summary_table([ref]).splitlines()[0]


def test_profiled_metric_is_a_transparent_proxy():
    inner = tm.MulticlassAccuracy(num_classes=3, device="cpu")
    pm = tools.ProfiledMetric(inner, name="acc", sync=True)
    pm.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    assert pm.num_total is inner.num_total and pm.to("cpu") is pm
    pm.num_total = torch.tensor(9.0)
    assert inner.num_total.item() == 9.0
    assert repr(pm).startswith("ProfiledMetric(") and pm.metric is inner
