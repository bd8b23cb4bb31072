"""Inputs made on the device from ``--seed``, by the generator a
configuration names in its ``inputs.kind``: ``inputs/<kind>.py``, found
by that name, with ``make(spec, n, seed, device)``.

Every seed gives the same sizes; only the values differ.  The same seed
on the same card gives the same tensors.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Any, Dict

import torch

from portbench.spec import HERE, find

Tensors = Dict[str, torch.Tensor]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def make(spec: Dict[str, Any], n: int, seed: int, device, bench_dir: Path = HERE) -> Tensors:
    """``n`` samples of the generator ``spec["kind"]`` names."""
    return find("inputs", spec["kind"], bench_dir).make(spec, n, seed, torch.device(device))
