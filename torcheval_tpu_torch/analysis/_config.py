"""tpulint run configuration for the PyTorch port: default targets,
scoped-out files and the baseline's place.

The defaults are anchored on the repo root derived from this file's
location, so ``python -m torcheval_tpu_torch.analysis`` (and a load of
this directory by path, as ``chip_smoke.py`` does on a GPU host) behave
identically from any CWD.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Tuple

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Analyzed when no paths are given: the library plus its maintained
# tooling (the GPU host's smoke run and the kernel A/B harness).  tests/
# is deliberately NOT a default target — tests call hook entry points
# directly with the bus enabled (that is their job); pass tests/
# explicitly to lint it anyway.
DEFAULT_TARGETS: Tuple[str, ...] = (
    "torcheval_tpu_torch",
    "chip_smoke.py",
    "kernel_ab.py",
)

# Other checkouts unpacked inside the repo for A/B runs (``kernel_ab.py
# --other _chip_archive/<dir>``): copies, not maintained code.  Matched
# as a path component below the repo root.
DEFAULT_EXCLUDES: Tuple[str, ...] = ("_chip_archive",)

# The port's baseline lives beside its analyzer (shipped as package
# data), apart from the JAX package's tpulint.baseline at the repo root.
DEFAULT_BASELINE_NAME = "tpulint.baseline"
BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), DEFAULT_BASELINE_NAME
)


@dataclass
class Config:
    paths: List[str] = field(default_factory=list)
    excludes: List[str] = field(
        default_factory=lambda: list(DEFAULT_EXCLUDES)
    )
    baseline: str = ""

    @classmethod
    def with_defaults(cls) -> "Config":
        cfg = cls()
        cfg.paths = [
            os.path.join(REPO_ROOT, t)
            for t in DEFAULT_TARGETS
            if os.path.exists(os.path.join(REPO_ROOT, t))
        ]
        if os.path.exists(BASELINE_PATH):
            cfg.baseline = BASELINE_PATH
        return cfg
