"""A real ``torch.distributed`` world for the port: 2, 3 and 4 gloo
processes on localhost, each running this file's worker body.  Each
process starts the world with ``initialize_multihost`` (twice: the second
call returns a new group over the same world) and checks ``default_group``,
the object collectives over ragged states, tagged point-to-point messages
through the c10d store (one larger than a store value) and a receive that
runs out with ``PeerTimeoutError``, a fold in rank order with
``LocalWorld``'s bits, and tree / ring / flat merges of an exact
``MulticlassAUROC`` equal to the single-process oracle.  The parent holds
each rank's reduction over one axis of a 2-D mesh against the JAX
package's ``shard_map`` over the same axis.  All of it on the CPU."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MESHES = {2: (2, 1), 3: (3, 1), 4: (2, 2)}
C = 4


def _shards(world):
    """Every rank's ragged block of the merge data, made from a seed."""
    out = []
    for rank in range(world):
        rng = np.random.default_rng(700 + rank)
        n = 50 + 17 * rank
        out.append((rng.random((n, C)).astype(np.float32), rng.integers(0, C, n).astype(np.int64)))
    return out


def _mesh_data():
    rng = np.random.default_rng(9)
    scores = rng.random((48, 5)).astype(np.float32)
    target = rng.integers(0, 5, 48).astype(np.int32)
    s = rng.random(96).astype(np.float32)
    t = (rng.random(96) < s).astype(np.float32)
    return scores, target, s, t


def _worker(rank: int, world: int, port: int) -> None:
    """One process of the world (run as ``python this_file rank world port``)."""
    import torch
    import torch.distributed as dist

    from torcheval_tpu_torch import distributed as D
    from torcheval_tpu_torch import parallel as tpar
    from torcheval_tpu_torch.metrics import MulticlassAUROC
    from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
        _multiclass_accuracy_update_kernel,
    )
    from torcheval_tpu_torch.metrics.toolkit import sync_and_compute

    group = D.initialize_multihost(f"localhost:{port}", world, rank)
    again = D.initialize_multihost(f"localhost:{port}", world, rank)
    assert again is not group and (again.rank, again.world_size) == (rank, world)
    assert isinstance(D.default_group(), D.TorchProcessGroup) and group.supports_p2p

    # Object collectives over ragged states.
    def obj(r):
        return {"r": r, "t": torch.arange(3 * r + 1, dtype=torch.float32), "l": [r] * (r + 1)}

    def same(a, b):
        return a["r"] == b["r"] and torch.equal(a["t"], b["t"]) and a["l"] == b["l"]

    gathered = group.all_gather_object(obj(rank))
    assert all(same(g, obj(r)) for r, g in enumerate(gathered))
    got = group.gather_object(obj(rank), dst=world - 1)
    assert (got is None) == (rank != world - 1)
    assert got is None or all(same(g, obj(r)) for r, g in enumerate(got))
    assert same(group.broadcast_object(obj(rank) if rank == 1 else None, src=1), obj(1))
    # A float sum folds in rank order: LocalWorld's bits.
    x = torch.tensor([0.1 * (rank + 1), 1e8 + rank, 3e-8 * rank], dtype=torch.float32)
    want = torch.tensor([0.1, 1e8, 0.0], dtype=torch.float32)
    for r in range(1, world):
        want = want + torch.tensor([0.1 * (r + 1), 1e8 + r, 3e-8 * r], dtype=torch.float32)
    assert torch.equal(group.all_reduce(x, "sum"), want)

    # Tagged point-to-point through the store, one message past a store value.
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    big = 3_000_000 if rank == 0 else 7
    group.send_object({"from": rank, "x": torch.full((big,), float(rank))}, nxt, "ring/0")
    msg = group.recv_object(prv, "ring/0", timeout=30.0)
    assert msg["from"] == prv and msg["x"].numel() == (3_000_000 if prv == 0 else 7)
    for timeout in (0.2, 0.0):
        t0 = time.monotonic()
        try:
            group.recv_object(nxt, "never", timeout=timeout)
        except D.PeerTimeoutError as exc:
            assert exc.peer == nxt and time.monotonic() - t0 < 5.0
        else:
            raise AssertionError("a receive with nothing sent returned")

    # Tree / ring / flat merges of an exact AUROC: the single-process oracle.
    shards = _shards(world)

    def metric(r):
        s, t = shards[r]
        return MulticlassAUROC(num_classes=C, device="cpu").update(
            torch.from_numpy(s), torch.from_numpy(t))

    oracle = [metric(r) for r in range(world)]
    for m in oracle:
        m._prepare_for_merge_state()
    oracle = oracle[0].merge_state(oracle[1:]).compute()
    mine = metric(rank)
    tree = sync_and_compute(mine, group, "all", topology="tree")
    ring = sync_and_compute(mine, group, world - 1, topology="ring")
    flat = sync_and_compute(mine, recipient_rank="all")  # the default group
    assert not tree.partial and tree.world_effective == world
    assert torch.equal(tree.value, oracle) and torch.equal(flat, oracle)
    assert (ring.value is None) == (rank != world - 1)
    assert ring.value is None or torch.equal(ring.value, oracle)

    # Reductions over one axis of a 2-D mesh.
    scores, target, s, t = _mesh_data()
    mesh = tpar.make_mesh(MESHES[world], ("dp", "sp"), group=group)
    sub = {}
    for axis in ("dp", "sp"):
        step = tpar.make_synced_update(
            lambda a, b: _multiclass_accuracy_update_kernel(a, b, "macro", 5, 1), mesh, axis=axis)
        counts = step(*tpar.shard_batch(mesh, torch.from_numpy(scores), torch.from_numpy(target),
                                        axis=axis))
        ps, pt = tpar.shard_batch(mesh, torch.from_numpy(s), torch.from_numpy(t), axis=axis)
        auc = tpar.sharded_auroc_histogram(ps, pt, mesh, axis=axis, num_bins=64)
        sub[axis] = [[c.tolist() for c in counts], float(auc)]
    dist.barrier()
    dist.destroy_process_group()
    print("RESULT " + json.dumps(sub), flush=True)


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:4]))
    sys.exit(0)


import pytest  # noqa: E402 - the worker body above runs without pytest or JAX


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world: int, timeout: float = 150.0):
    """Every rank's parsed result; one deadline for the whole world, and a
    rank that fails or hangs fails the test with every rank's output."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)  # the worker runs by path: put the repo on sys.path
    env["CUDA_VISIBLE_DEVICES"] = ""
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         cwd=ROOT, env=env)
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    outputs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                outputs.append(("timeout", out))
                continue
            outputs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    report = "\n".join(f"--- rank {r} ({rc}) ---\n{out[-3000:]}"
                       for r, (rc, out) in enumerate(outputs))
    assert all(rc == 0 for rc, _ in outputs), report
    results = []
    for _, out in outputs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, report
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


@pytest.mark.parametrize("world", [2, 3, 4])
def test_gloo_world_matches_the_single_process_and_jax(world):
    import jax.numpy as jnp

    from torcheval_tpu import parallel as jpar
    from torcheval_tpu.metrics.functional.classification.accuracy import (
        _multiclass_accuracy_update_kernel as jax_accuracy_update,
    )

    results = _run_world(world)
    scores, target, s, t = _mesh_data()
    jm = jpar.make_mesh(MESHES[world], ("dp", "sp"))
    for axis in ("dp", "sp"):
        step = jpar.make_synced_update(
            lambda a, b: jax_accuracy_update(a, b, "macro", 5, 1), jm, axis=axis)
        want = step(*jpar.shard_batch(jm, jnp.asarray(scores), jnp.asarray(target), axis=axis))
        js, jt = jpar.shard_batch(jm, jnp.asarray(s), jnp.asarray(t), axis=axis)
        want_auc = float(jpar.sharded_auroc_histogram(js, jt, jm, axis=axis, num_bins=64))
        for rank, res in enumerate(results):
            counts, auc = res[axis]
            for got, x in zip(counts, want):
                np.testing.assert_array_equal(np.asarray(got), np.asarray(x), err_msg=str(rank))
            assert abs(auc - want_auc) <= 1e-6, (rank, axis, auc, want_auc)


def test_without_a_world_the_default_group_is_the_single_process():
    from torcheval_tpu_torch import distributed as D

    assert isinstance(D.default_group(), D.SingleProcessGroup)
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        D.TorchProcessGroup()
