"""The no-JAX check compares whole top-level names; a run's process
loads none of the forbidden modules."""

import json
import subprocess
import sys

from portbench import guard
from portbench.tests.tiny import ROOT


def test_top_level_names_are_compared_whole():
    names = [
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "torcheval_tpu", "torcheval_tpu.metrics",
        "torcheval_tpu_torch", "torcheval_tpu_torch.metrics", "jaxtyping", "portbench",
    ]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "torcheval_tpu", "torcheval_tpu.metrics",
    ]


CHILD = """
import json, sys, time
import torch
from portbench import guard
from portbench.tests.tiny import CELLS, run_tiny, tiny_cell
for name in CELLS:
    out = run_tiny(tiny_cell(name), trace=True)
    assert out["correct"], (name, out["checks"])
print(json.dumps({"forbidden": guard.forbidden_modules(),
                  "flags": guard.non_default_flags()}))
"""


def test_a_run_loads_no_jax_and_sets_no_flag():
    # a fresh process: the test process may hold JAX through other tests
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith("TORCHEVAL_TPU_TORCH_")}
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600, check=False)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "flags": {}}


def test_a_cpu_only_host_gets_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "imagenet1k.eager",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=False,
        env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
