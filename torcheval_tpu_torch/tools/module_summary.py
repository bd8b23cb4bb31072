"""Module summaries for ``torch.nn.Module`` trees: parameter, size and
FLOP trees (the port of ``torcheval_tpu/tools/module_summary.py``, with
upstream torcheval's ``torcheval/tools/module_summary.py`` API).

The JAX package walks flax variables and prices each submodule call with
XLA cost analysis.  The port walks the module tree, as upstream does:
a forward pre-hook on every submodule records the inputs of its
outermost call during one forward of the root, and each recorded call is
then priced on its own with :func:`~torcheval_tpu_torch.tools.flops
.forward_backward_flops` (``FlopCounterMode``: products, convolutions and
attention; no elementwise op) and, for a module on the card,
:func:`~torcheval_tpu_torch.tools.flops.peak_memory_of`.

Parameters and buffers both count in ``num_parameters`` (buffers, such as
batch-norm running statistics, are the non-trainable part, as flax's
``batch_stats`` are in the JAX package); ``num_trainable_parameters``
counts the parameters that require a gradient.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.tools.flops import (
    UNKNOWN_FLOPS,
    _card_of,
    _peak_bytes,
    forward_backward_flops,
    peak_memory_of,
)

_PARAMETER_NUM_UNITS = [" ", "K", "M", "B", "T"]
_FLOP_UNITS = [" ", "K", "M", "G", "T"]

_ATTRIBS: List[str] = [
    "module_name",
    "module_type",
    "num_parameters",
    "num_trainable_parameters",
    "size_bytes",
    "flops_forward",
    "flops_backward",
    "peak_memory_bytes",
]
_ATTRIB_TO_COL_HEADER: Dict[str, str] = {
    "module_name": "Name",
    "module_type": "Type",
    "num_parameters": "# Parameters",
    "num_trainable_parameters": "# Trainable Parameters",
    "size_bytes": "Size (bytes)",
    "flops_forward": "Forward FLOPs",
    "flops_backward": "Backward FLOPs",
    "peak_memory_bytes": "Peak Memory (bytes)",
}


class ModuleSummary:
    """Summary node for one (sub)module: parameter counts, byte size, FLOPs,
    and the child summaries (upstream ``ModuleSummary``)."""

    def __init__(self) -> None:
        self._module_name: str = ""
        self._module_type: str = ""
        self._num_parameters: int = 0
        self._num_trainable_parameters: int = 0
        self._size_bytes: int = 0
        self._flops_forward: int = UNKNOWN_FLOPS
        self._flops_backward: int = UNKNOWN_FLOPS
        self._peak_memory_bytes: int = UNKNOWN_FLOPS
        self._has_uninitialized_param: bool = False
        self._submodule_summaries: Dict[str, "ModuleSummary"] = {}

    @property
    def submodule_summaries(self) -> Dict[str, "ModuleSummary"]:
        """Summaries of the direct children, keyed by dotted path name."""
        return self._submodule_summaries

    @property
    def module_name(self) -> str:
        return self._module_name

    @property
    def module_type(self) -> str:
        return self._module_type

    @property
    def num_parameters(self) -> int:
        """Parameters and buffers at or below this module."""
        return self._num_parameters

    @property
    def num_trainable_parameters(self) -> int:
        """Parameters that require a gradient."""
        return self._num_trainable_parameters

    @property
    def flops_forward(self) -> int:
        """Forward FLOPs (``FlopCounterMode``); -1 when unknown."""
        return self._flops_forward

    @property
    def flops_backward(self) -> int:
        """Backward FLOPs (gradient of the mean minus forward); -1 when
        unknown."""
        return self._flops_backward

    @property
    def peak_memory_bytes(self) -> int:
        """Largest card peak across this module's recorded calls
        (arguments, outputs and temporaries); -1 when unknown (a module
        on the CPU)."""
        return self._peak_memory_bytes

    @property
    def size_bytes(self) -> int:
        """Total byte size of the parameters and buffers at or below this
        module."""
        return self._size_bytes

    @property
    def has_uninitialized_param(self) -> bool:
        """Whether a lazy parameter (``nn.parameter.UninitializedParameter``)
        is still unmaterialized at or below this module."""
        return self._has_uninitialized_param

    def __repr__(self) -> str:
        return f"ModuleSummary({self._module_name!r}, type={self._module_type!r})"

    def __str__(self) -> str:
        return get_summary_table(self)


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _numel(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    return int(np.asarray(x).size)


def _detached(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach()
    if isinstance(value, tuple):
        return tuple(_detached(v) for v in value)
    if isinstance(value, list):
        return [_detached(v) for v in value]
    if isinstance(value, dict):
        return {k: _detached(v) for k, v in value.items()}
    return value


def _record_calls(
    module: torch.nn.Module, args: Sequence[Any], kwargs: Mapping[str, Any]
) -> Dict[str, List[Tuple[tuple, dict]]]:
    """Inputs of every submodule's outermost calls during one forward of
    ``module`` (a module re-entered inside its own call is recorded once,
    so its FLOPs are not doubled)."""
    records: Dict[str, List[Tuple[tuple, dict]]] = {}
    active: Dict[str, int] = {}
    handles = []

    def pre(name):
        def hook(mod, a, kw):
            if not active.get(name):
                records.setdefault(name, []).append((_detached(a), _detached(kw)))
            active[name] = active.get(name, 0) + 1

        return hook

    def post(name):
        def hook(mod, a, kw, out):
            active[name] -= 1

        return hook

    for name, sub in module.named_modules():
        handles.append(sub.register_forward_pre_hook(pre(name), with_kwargs=True))
        handles.append(sub.register_forward_hook(post(name), with_kwargs=True))
    try:
        with torch.no_grad():
            module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return records


def get_module_summary(
    module: torch.nn.Module,
    module_args: Sequence[Any] = (),
    module_kwargs: Optional[Mapping[str, Any]] = None,
    *,
    compute_flops: bool = True,
) -> ModuleSummary:
    """Build the summary tree of ``module`` (upstream
    ``get_module_summary``).

    ``module_args`` / ``module_kwargs`` are one example input (needed for
    FLOPs and peak memory; ``meta`` tensors count FLOPs of a module on the
    ``meta`` device without computing).  ``compute_flops=False`` leaves
    the FLOP and memory columns unknown and runs nothing."""
    module_kwargs = dict(module_kwargs or {})
    records: Dict[str, List[Tuple[tuple, dict]]] = {}
    if compute_flops:
        try:
            records = _record_calls(module, module_args, module_kwargs)
        except Exception:
            compute_flops = False

    def make_node(name: str, sub: torch.nn.Module) -> ModuleSummary:
        s = ModuleSummary()
        s._module_name = name
        s._module_type = type(sub).__name__
        params = list(sub.parameters())
        buffers = list(sub.buffers())
        s._has_uninitialized_param = any(
            isinstance(p, torch.nn.parameter.UninitializedParameter) for p in params
        )
        live = [p for p in params if not isinstance(p, torch.nn.parameter.UninitializedParameter)]
        s._num_parameters = sum(_numel(p) for p in live) + sum(_numel(b) for b in buffers)
        s._num_trainable_parameters = sum(_numel(p) for p in live if p.requires_grad)
        s._size_bytes = sum(_nbytes(p) for p in live) + sum(_nbytes(b) for b in buffers)
        if compute_flops and name in records:
            fwd = bwd = 0
            peak = UNKNOWN_FLOPS
            for args, kwargs in records[name]:
                f, b = forward_backward_flops(sub, *args, **kwargs)
                fwd = UNKNOWN_FLOPS if UNKNOWN_FLOPS in (f, fwd) else fwd + f
                bwd = UNKNOWN_FLOPS if UNKNOWN_FLOPS in (b, bwd) else bwd + b
                try:
                    with torch.no_grad():
                        peak = max(peak, peak_memory_of(sub, *args, **kwargs))
                except Exception:
                    pass
            s._flops_forward = fwd
            s._flops_backward = bwd
            s._peak_memory_bytes = peak
        return s

    root = make_node("", module)
    nodes: Dict[str, ModuleSummary] = {"": root}
    for name, sub in module.named_modules():
        if not name:
            continue
        node = make_node(name, sub)
        nodes[name] = node
        parent = nodes.get(name.rpartition(".")[0], root)
        parent._submodule_summaries[name] = node
    return root


def get_params_summary(
    params: Any,
    *,
    apply_fn: Optional[Any] = None,
    example_args: Sequence[Any] = (),
    example_kwargs: Optional[Mapping[str, Any]] = None,
    name: str = "model",
) -> ModuleSummary:
    """Summary tree for a parameter mapping that is not a module (a
    ``state_dict``, a nested dict of tensors or numpy arrays): every
    mapping level becomes a node with parameter counts and byte sizes.
    When ``apply_fn`` is given, the forward / backward FLOPs of
    ``apply_fn(params, *example_args)`` (gradient with respect to every
    floating tensor of ``params``) are attached to the root."""

    def make_node(node: Any, path: Tuple[str, ...]) -> ModuleSummary:
        s = ModuleSummary()
        s._module_name = ".".join(path) if path else name
        s._module_type = type(node).__name__
        leaves = _leaves(node)
        count = sum(_numel(x) for x in leaves)
        s._num_parameters = count
        s._num_trainable_parameters = count
        s._size_bytes = sum(_nbytes(x) for x in leaves)
        if isinstance(node, Mapping):
            for key, child in node.items():
                if isinstance(child, Mapping):
                    child_path = path + (str(key),)
                    s._submodule_summaries[".".join(child_path)] = make_node(
                        child, child_path
                    )
        return s

    root = make_node(params, ())
    if apply_fn is not None:
        grads = _with_grad(params)
        wrt = [x for x in _leaves(grads) if isinstance(x, torch.Tensor) and x.requires_grad]
        fwd, bwd = forward_backward_flops(
            lambda *a, **kw: apply_fn(grads, *a, **kw),
            *example_args,
            wrt=wrt,
            **(example_kwargs or {}),
        )
        root._flops_forward = fwd
        root._flops_backward = bwd
        device = _card_of([*wrt, *example_args])
        if device is not None:
            with torch.no_grad():
                root._peak_memory_bytes = _peak_bytes(
                    device,
                    lambda: apply_fn(grads, *example_args, **(example_kwargs or {})),
                    [*wrt, *example_args],
                )
    return root


def _leaves(node: Any) -> List[Any]:
    if isinstance(node, Mapping):
        return [x for v in node.values() for x in _leaves(v)]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in _leaves(v)]
    if isinstance(node, (torch.Tensor, np.ndarray)):
        return [node]
    return []


def _with_grad(node: Any) -> Any:
    """A copy of ``node`` whose floating tensors are leaves that require a
    gradient (numpy arrays become tensors)."""
    if isinstance(node, Mapping):
        return {k: _with_grad(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_with_grad(v) for v in node)
    if isinstance(node, np.ndarray):
        node = torch.from_numpy(node)
    if isinstance(node, torch.Tensor):
        node = node.detach()
        if node.is_floating_point():
            node = node.clone().requires_grad_(True)
    return node


def prune_module_summary(module_summary: ModuleSummary, *, max_depth: int) -> None:
    """Drop summaries deeper than ``max_depth``, in place (upstream
    ``prune_module_summary``)."""
    if max_depth < 1:
        raise ValueError(
            f"`max_depth` must be an int greater than 0. Got {max_depth}."
        )
    if max_depth == 1:
        module_summary._submodule_summaries = {}
        return
    for sub in module_summary._submodule_summaries.values():
        prune_module_summary(sub, max_depth=max_depth - 1)


def get_summary_table(
    module_summary: ModuleSummary, human_readable_nums: bool = True
) -> str:
    """Render the summary tree as an aligned text table (upstream
    ``get_summary_table``)."""
    stop_attr = set()
    if module_summary.flops_forward == UNKNOWN_FLOPS:
        stop_attr.add("flops_forward")
    if module_summary.flops_backward == UNKNOWN_FLOPS:
        stop_attr.add("flops_backward")
    if module_summary.peak_memory_bytes == UNKNOWN_FLOPS:
        stop_attr.add("peak_memory_bytes")
    attribs = [a for a in _ATTRIBS if a not in stop_attr]

    rows: List[List[str]] = []

    def fmt(attr: str, value: Any) -> str:
        if isinstance(value, bool) or not isinstance(value, int):
            return str(value)
        if not human_readable_nums:
            return str(value)
        if value < 0:
            return "?"
        if attr in ("size_bytes", "peak_memory_bytes"):
            return _readable_size(value)
        units = _FLOP_UNITS if attr.startswith("flops") else _PARAMETER_NUM_UNITS
        return _get_human_readable_count(value, labels=units)

    def visit(node: ModuleSummary) -> None:
        rows.append([fmt(a, getattr(node, a)) for a in attribs])
        for sub in node.submodule_summaries.values():
            visit(sub)

    visit(module_summary)

    headers = [_ATTRIB_TO_COL_HEADER[a] for a in attribs]
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) for i, h in enumerate(headers)
    ]
    lines = [
        " | ".join(h.ljust(w) for h, w in zip(headers, widths)),
        "-" * (sum(widths) + 3 * (len(widths) - 1)),
    ]
    for r in rows:
        lines.append(" | ".join(c.ljust(w) for c, w in zip(r, widths)))
    table = "\n".join(lines) + "\n"
    if "flops_forward" not in stop_attr or "flops_backward" not in stop_attr:
        table += (
            "Remark for FLOPs calculation: counts come from torch's "
            "FlopCounterMode over each submodule's recorded call (forward) "
            "and over the gradient of the mean of its outputs minus forward "
            "(backward), upstream's `loss = model(input).mean(); "
            "loss.backward()` convention. Products, convolutions and "
            "attention are counted; elementwise ops and the loss are not.\n"
        )
    return table


def _readable_size(num_bytes: int) -> str:
    if num_bytes <= 0:
        return str(num_bytes)
    units = ["B", "KiB", "MiB", "GiB", "TiB"]
    exp = min(int(math.log(num_bytes, 1024)), len(units) - 1)
    value = num_bytes / 1024**exp
    return f"{value:,.1f} {units[exp]}" if exp else f"{num_bytes} B"


def _get_human_readable_count(
    number: int, labels: Optional[List[str]] = None
) -> str:
    """Abbreviate an integer with K/M/B/T suffixes (upstream's rule: below
    100 of a unit keeps one decimal, otherwise a comma-grouped integer)."""
    if not isinstance(number, int):
        raise TypeError(f"expected an int to abbreviate, got {type(number)}")
    if number < 0:
        raise ValueError(f"expected a non-negative count, got {number}")
    labels = labels if labels is not None else _PARAMETER_NUM_UNITS
    if not labels:
        raise ValueError(
            f"expected at least one unit label to abbreviate with, got {labels}"
        )
    group = 0
    value = float(number)
    while value >= 1000 and group < len(labels) - 1:
        value /= 1000.0
        group += 1
    if group == 0 or value >= 100:
        return f"{int(value):,d} {labels[group]}"
    return f"{value:,.1f} {labels[group]}"
