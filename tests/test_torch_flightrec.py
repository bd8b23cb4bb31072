"""The port's flight recorder against the JAX package's: a bundle written
by either package validates, reads and renders the same in the other;
tampered and incomplete bundles are refused by both; fault firings,
corrupt data and excisions trigger bundles; the cooldown suppresses
repeats; the manifest carries the trace tree and the flags.  Everything
on the CPU."""

import contextlib
import json
import os

import pytest

from torcheval_tpu.resilience import FaultPlan as JaxFaultPlan
from torcheval_tpu.resilience import faults as jax_faults
from torcheval_tpu.telemetry import __main__ as jax_cli
from torcheval_tpu.telemetry import flightrec as jax_flightrec

from torcheval_tpu_torch.resilience import FaultPlan, InjectedFault, MembershipView, faults
from torcheval_tpu_torch.telemetry import __main__ as port_cli
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import flightrec
from torcheval_tpu_torch.telemetry import trace

from tests.test_torch_telemetry import jax_events, reset_all


@pytest.fixture(autouse=True)
def _isolated():
    reset_all()
    yield
    reset_all()


def _port_bundle(directory, traced=False):
    flightrec.enable(dir=str(directory), last_events=8)
    port_events.enable()
    if traced:
        trace.enable()
    ctx = trace.root("eval") if traced else None
    with trace.activate(ctx) if traced else contextlib.nullcontext():
        for i in range(12):
            port_events.record_sync(f"op{i}", 0.001 * i, 10 * i)
        with FaultPlan([{"site": "collective", "on_attempt": 2}]):
            with pytest.raises(InjectedFault):
                faults.fire("collective", op="all_gather_object", attempt=2)
    (path,) = flightrec.bundles()
    return path, ctx


def _jax_bundle(directory):
    jax_flightrec.enable(dir=str(directory), last_events=8)
    jax_events.enable()
    for i in range(12):
        jax_events.record_sync(f"op{i}", 0.001 * i, 10 * i)
    with JaxFaultPlan([{"site": "collective", "on_attempt": 2}]):
        with pytest.raises(jax_faults.InjectedFault):
            jax_faults.fire("collective", op="all_gather_object", attempt=2)
    return jax_flightrec.last_bundle()


def test_a_port_bundle_validates_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_TRACE", "1")
    path, ctx = _port_bundle(tmp_path, traced=True)
    assert os.path.basename(path) == "bundle-0001-fault_fired"
    assert flightrec.validate_bundle(path) == [] and jax_flightrec.validate_bundle(path) == []
    ours, theirs = flightrec.read_bundle(path), jax_flightrec.read_bundle(path)
    assert ours == theirs
    m = ours["manifest"]
    assert m["format"] == jax_flightrec.BUNDLE_FORMAT == flightrec.BUNDLE_FORMAT
    assert m["reason"] == "fault_fired" and m["event_count"] == 8 == len(ours["events"])
    assert [e["op"] for e in ours["events"]] == [f"op{i}" for i in range(4, 12)]
    assert m["flags"] == {"TORCHEVAL_TPU_TORCH_TRACE": True}
    assert m["program_profiles"] == [] and "tenants.json" not in m["files"]
    assert m["trigger_trace_id"] == ctx.trace_id and m["trace_tree"]
    assert m["health"] == {"enabled": False, "raise_on_corrupt": False}
    assert json.loads(open(os.path.join(path, "trace.perfetto.json")).read())["traceEvents"]
    assert flightrec.format_bundle(ours) == jax_flightrec.format_bundle(ours)


def test_a_jax_bundle_validates_and_renders_in_the_port(tmp_path, capsys):
    path = _jax_bundle(tmp_path)
    assert flightrec.validate_bundle(path) == []
    bundle = flightrec.read_bundle(path)
    assert bundle == jax_flightrec.read_bundle(path)
    assert flightrec.format_bundle(bundle) == jax_flightrec.format_bundle(bundle)
    assert port_cli.main(["--flight", path]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["--flight", path]) == 0
    assert ours == capsys.readouterr().out


@pytest.mark.parametrize("damage", ["tamper", "truncate", "no_manifest", "bad_format"])
def test_damaged_bundles_are_refused_by_both(tmp_path, damage, capsys):
    path, _ = _port_bundle(tmp_path)
    events_file = os.path.join(path, "events.jsonl")
    manifest_file = os.path.join(path, flightrec.MANIFEST_NAME)
    if damage == "tamper":
        data = bytearray(open(events_file, "rb").read())
        data[5] ^= 1
        open(events_file, "wb").write(bytes(data))
    elif damage == "truncate":
        open(events_file, "ab").write(b"{not json\n")
    elif damage == "no_manifest":
        os.remove(manifest_file)
    else:
        m = json.load(open(manifest_file))
        m["format"] = "something-else/9"
        open(manifest_file, "w").write(json.dumps(m))
    problems = flightrec.validate_bundle(path)
    assert problems and problems == jax_flightrec.validate_bundle(path)
    with pytest.raises(flightrec.BundleError):
        flightrec.read_bundle(path)
    assert port_cli.main(["--flight", path]) == 2
    assert flightrec.validate_bundle(str(tmp_path / "nowhere")) == [
        f"not a directory: {tmp_path / 'nowhere'}"]


def test_cooldown_suppresses_and_reset_clears(tmp_path):
    flightrec.enable(dir=str(tmp_path), cooldown_s=60.0)
    first = flightrec.trigger("a")
    assert first is not None and flightrec.trigger("b") is None
    assert flightrec.suppressed() == 1 and flightrec.bundles() == [first]
    flightrec.reset()
    assert flightrec.suppressed() == 0 and flightrec.bundles() == []
    flightrec.enable(cooldown_s=0)
    second = flightrec.trigger("weird reason/with:chars", extra={"k": {1, 2}, (1, 2): "t"})
    assert os.path.basename(second) == "bundle-0001-weird-reason-with-chars"
    assert json.load(open(os.path.join(second, "MANIFEST.json")))["extra"]["k"] == [1, 2]
    with pytest.raises(ValueError, match="last_events must be >= 1"):
        flightrec.enable(last_events=0)


def test_an_unwritable_directory_warns_and_returns_none(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    flightrec.enable(dir=str(blocker / "sub"), cooldown_s=0)
    with pytest.warns(RuntimeWarning, match="failed to write bundle"):
        assert flightrec.trigger("x") is None


def test_an_excision_writes_a_bundle_with_the_membership_view(tmp_path):
    flightrec.enable(dir=str(tmp_path), cooldown_s=0)
    view = MembershipView(4, 0)
    assert view.excise(2, "silent")
    (path,) = flightrec.bundles()
    m = flightrec.read_bundle(path)["manifest"]
    assert m["reason"] == "excision" and m["membership"]["dead"] == [2]
    assert jax_flightrec.validate_bundle(path) == []


def test_recorder_off_observes_nothing():
    port_events.enable()
    port_events.record_sync("op", 0.1, 1)
    assert list(flightrec._recent) == [] and not flightrec.enabled()
    flightrec.enable()
    port_events.record_sync("op", 0.1, 1)
    assert [e.kind for e in flightrec._recent] == ["sync"]
