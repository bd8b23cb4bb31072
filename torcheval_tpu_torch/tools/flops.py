"""FLOP counting with ``torch.utils.flop_counter.FlopCounterMode`` (the
port of ``torcheval_tpu/tools/flops.py``).

Upstream torcheval counts FLOPs by interposing on the torch dispatcher
with a table of per-op formulas (``torcheval/tools/flops.py``); the JAX
package asks XLA's compiled cost analysis instead.  The port is back on
the dispatcher, through the counter that ships with torch: it prices the
matrix products, convolutions and attention ops (``2·m·k·n`` for a
product) and counts no elementwise op, where XLA's cost model also counts
one FLOP an element for adds, activations and reductions.

The calls run: arguments may be tensors on any device, ``meta`` tensors
included, on which nothing is computed.  Backward FLOPs follow upstream's
``model(input).mean().backward()`` convention: the cost of the gradient
of the mean of the floating outputs, minus the forward's.

Left out of the JAX module: ``normalize_cost_analysis`` and
``memory_stats_of``, which read XLA's compiled objects; the port compiles
none.  :func:`peak_memory_of` reads the CUDA caching allocator instead.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

UNKNOWN_FLOPS = -1


def _counter():
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False)


def flops_of(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> int:
    """FLOPs of ``fn(*args, **kwargs)`` as ``FlopCounterMode`` counts them
    (products, convolutions, attention; see the module docstring).  The
    call runs; pass ``meta`` tensors to count without computing."""
    with _counter() as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def _float_leaves(out: Any) -> list:
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, Mapping):
        return [x for v in out.values() for x in _float_leaves(v)]
    if isinstance(out, (tuple, list)):
        return [x for v in out for x in _float_leaves(v)]
    return []


def forward_backward_flops(
    fn: Callable[..., Any],
    *args: Any,
    wrt: Optional[Sequence[torch.Tensor]] = None,
    **kwargs: Any,
) -> Tuple[int, int]:
    """(forward, backward) FLOPs of ``fn(*args, **kwargs)``.

    Backward is the extra cost of the gradient of the mean of the floating
    outputs with respect to ``wrt`` (default: the trainable parameters of
    ``fn`` when it is an ``nn.Module``), the counterpart of upstream's
    ``model(input).mean().backward()``.  No ``.grad`` is written.  Either
    value degrades to ``UNKNOWN_FLOPS`` (-1) rather than raising (no
    floating output, nothing to differentiate)."""
    try:
        fwd = flops_of(fn, *args, **kwargs)
    except Exception:
        return UNKNOWN_FLOPS, UNKNOWN_FLOPS
    if wrt is None:
        wrt = (
            [p for p in fn.parameters() if p.requires_grad]
            if isinstance(fn, torch.nn.Module)
            else []
        )
    wrt = list(wrt)
    if not wrt:
        return fwd, UNKNOWN_FLOPS
    try:
        with torch.enable_grad(), _counter() as counter:
            leaves = _float_leaves(fn(*args, **kwargs))
            if not leaves:
                raise TypeError("no floating outputs to differentiate")
            loss = sum(x.mean() for x in leaves) / len(leaves)
            torch.autograd.grad(loss, wrt, allow_unused=True)
        total = int(counter.get_total_flops())
    except Exception:
        return fwd, UNKNOWN_FLOPS
    return fwd, max(total - fwd, 0)


def _card_of(values: Iterable[Any]) -> Optional[torch.device]:
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            return v.device
        if isinstance(v, torch.nn.Module):
            for p in v.parameters():
                if p.device.type == "cuda":
                    return p.device
    return None


def peak_memory_of(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> int:
    """Peak card bytes of ``fn(*args, **kwargs)``: what the CUDA caching
    allocator held above its level before the call, at its highest during
    the call, plus the card tensors among the arguments (arguments,
    outputs and temporaries, as the JAX package's live-set figure counts
    them).  Runs the call.  Raises ``RuntimeError`` when no argument (nor
    ``fn``, as a module) lives on a GPU: the CPU has no allocator
    statistics to read."""
    device = _card_of([fn, *args, *kwargs.values()])
    if device is None:
        raise RuntimeError(
            "peak_memory_of reads the CUDA caching allocator; no argument is on a GPU."
        )
    return _peak_bytes(device, lambda: fn(*args, **kwargs), (*args, *kwargs.values()))


def _peak_bytes(device: torch.device, call: Callable[[], Any], held: Iterable[Any]) -> int:
    """The allocator's peak above its level before ``call()``, plus the
    bytes of the tensors of ``held`` that live on ``device``."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    call()
    torch.cuda.synchronize(device)
    held_bytes = sum(
        v.numel() * v.element_size()
        for v in held
        if isinstance(v, torch.Tensor) and v.device == device
    )
    return int(torch.cuda.max_memory_allocated(device) - base + held_bytes)


def cost_summary(
    fn: Callable[..., Any], *args: Any, **kwargs: Any
) -> Optional[Dict[str, Any]]:
    """The counter's breakdown of ``fn(*args, **kwargs)``: ``{"flops":
    total, "by_op": {op name: FLOPs}}``, the counterpart of upstream's
    per-op ``flop_counts``; ``None`` when the call counts nothing."""
    with _counter() as counter:
        fn(*args, **kwargs)
    total = int(counter.get_total_flops())
    if not total:
        return None
    by_op = counter.get_flop_counts().get("Global", {})
    return {"flops": total, "by_op": {str(op): int(n) for op, n in by_op.items()}}
