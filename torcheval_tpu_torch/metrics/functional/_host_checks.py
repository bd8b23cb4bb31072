"""Where functional inputs live, and the data-dependent (value) checks of
update inputs.

The port's slice of ``torcheval_tpu/metrics/functional/_host_checks.py``.
A value check reads numbers back from the device, which waits for it; the
helpers fuse all of a validation's reductions into ONE read back, and the
switches let a throughput-critical loop on pre-validated data skip it.
Each read back is counted by the ``site`` its caller names
(``_stats.readback``), and runs in a ``readback.<site>`` profiler range
with the telemetry ranges on; :func:`check_index_ranges` runs in a
``check.<site>`` range.

Every value check goes through :func:`value_check`: the device values it
needs (the minimum and maximum of tensors, or one flag), its site, and a
judge that takes their host values and raises the check's ``ValueError``
or returns.  Alone, the check reads back at once.  Inside a
:class:`CheckQueue` (``MetricCollection.update``'s graph path) it is
queued, and the queue answers every pending check with one read back:
one ``aminmax`` a tensor however many checks read it, one stacked vector,
judged in the order queued.
"""

from contextlib import contextmanager
from contextvars import ContextVar
from functools import partial, reduce
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch import _flags, _stats
from torcheval_tpu_torch.telemetry import events as _telemetry

_SKIP_CHECKS: ContextVar = ContextVar(
    "torcheval_tpu_torch_skip_value_checks", default=False
)


@contextmanager
def skip_value_checks():
    """Disable data-dependent (value) validation inside the block.  Shape
    and parameter validation still applies.  Process-wide:
    ``TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS=1``."""
    token = _SKIP_CHECKS.set(True)
    try:
        yield
    finally:
        _SKIP_CHECKS.reset(token)


def value_checks_enabled() -> bool:
    """False inside :func:`skip_value_checks` or when
    ``TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS`` is truthy (read per call)."""
    if _SKIP_CHECKS.get():
        return False
    return not _flags.get("SKIP_VALUE_CHECKS")


def all_concrete(*tensors) -> bool:
    """Always True: PyTorch runs eagerly, so every input's values can be
    read.  Kept so code ported from the JAX package, where this is False
    under tracing, reads the same."""
    return True


def place_inputs(*values) -> Tuple[torch.Tensor, ...]:
    """The tensors a functional metric computes on.  A ``torch.Tensor``
    stays on its own device: the caller chose it.  Anything else (a numpy
    array, a list, a number) goes where the call's first tensor lies, or
    to the GPU when no argument is a tensor, as a metric built without
    ``device=`` does; with no GPU that raises, naming CPU tensors as the
    way to run on the CPU.  The port never picks the CPU on its own."""
    device = next((v.device for v in values if isinstance(v, torch.Tensor)), None)
    if device is None and not all(isinstance(v, torch.Tensor) for v in values):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torcheval_tpu_torch functional metrics place numpy arrays and "
                "lists on the GPU, but no CUDA device is available; pass CPU "
                "tensors (torch.as_tensor(x)) to run on the CPU."
            )
        device = torch.device("cuda")
    return tuple(
        v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device)
        for v in values
    )


def x64_off(*values):
    """Each of ``values`` with a float64 tensor cast to float32 (anything
    else, ``None`` included, as it is): the dtypes the JAX package holds
    with x64 off, so the states and results of an f64-fed metric carry
    across to an f32-fed one (``state_dict``, ``merge_state``)."""
    return tuple(
        v.to(torch.float32)
        if isinstance(v, torch.Tensor) and v.dtype == torch.float64
        else v
        for v in values
    )


def to_host(*tensors: torch.Tensor, site: str) -> Tuple[np.ndarray, ...]:
    """numpy copies of ``tensors`` with ONE wait for the device: every copy
    is queued before the stream is synchronized once.  ``site`` names the
    read back."""
    return _stats.readback(site, _to_host, *tensors)


def _to_host(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    if all(t.device.type == "cpu" for t in tensors):
        return tuple(t.numpy() for t in tensors)
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.current_stream(device).synchronize()
    return tuple(h.numpy() for h in host)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def bounds(*tensors: torch.Tensor, site: str) -> np.ndarray:
    """``[min0, max0, min1, max1, ...]`` of the tensors with ONE read back,
    in their promoted dtype (float32 at least, float64 when an input is).
    Exact for integer class indices below 2^24.  Callers skip empty
    tensors themselves (their min does not exist).  ``site`` names the
    read back."""
    dtype = _promoted(tensors)
    stacked = torch.stack([m.to(dtype) for t in tensors for m in torch.aminmax(t)])
    return _stats.readback(site, _numpy, stacked)


def _promoted(tensors: Sequence[torch.Tensor]) -> torch.dtype:
    return reduce(torch.promote_types, (t.dtype for t in tensors), torch.float32)


class _Request(NamedTuple):
    """One value check: what it reads (the extrema of ``tensors``, or the
    0-d ``flag``), where, and the judge of the host values."""

    site: str
    judge: Callable[[Any], None]
    tensors: Tuple[torch.Tensor, ...]
    flag: Optional[torch.Tensor]


def _read_alone(request: _Request) -> Any:
    """The host values of one check, read at its own site: :func:`bounds`
    of its tensors, or ``bool`` of its flag."""
    if request.flag is not None:
        return _stats.readback(request.site, bool, request.flag)
    return bounds(*request.tensors, site=request.site)


_QUEUE: ContextVar[Optional["CheckQueue"]] = ContextVar(
    "torcheval_tpu_torch_check_queue", default=None
)


def value_check(
    site: str,
    judge: Callable[[Any], None],
    *tensors: torch.Tensor,
    flag: Optional[torch.Tensor] = None,
) -> None:
    """Run one value check: ``judge`` gets the host values of ``[min0,
    max0, min1, max1, ...]`` of the non-empty ``tensors`` (as
    :func:`bounds` gives them) or, with ``flag=``, ``bool`` of that 0-d
    tensor, and raises the check's ``ValueError`` or returns.  Outside a
    :class:`CheckQueue` it reads back at once, counted at ``site``;
    inside one it is queued, and judged when the queue is flushed."""
    request = _Request(site, judge, tensors, flag)
    queue = _QUEUE.get()
    if queue is None:
        judge(_read_alone(request))
    else:
        queue.pending.append(request)


class CheckQueue:
    """The value checks of several members' validations, read back
    together.  ``with queue.scope(member):`` around one member's
    validation queues its :func:`value_check` calls; :meth:`flush` reads
    every pending check with one read back and judges them in the order
    queued, so the first to fail raises, as it would have alone."""

    def __init__(self) -> None:
        self.pending: List[_Request] = []
        # The members whose checks are pending, in order.
        self.members: List[str] = []
        self._member = ""
        self._queued = 0
        self._token: Any = None

    def scope(self, member: str) -> "CheckQueue":
        self._member = member
        return self

    def __enter__(self) -> "CheckQueue":
        self._queued = len(self.pending)
        self._token = _QUEUE.set(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        _QUEUE.reset(self._token)
        if len(self.pending) > self._queued:
            self.members.append(self._member)

    def flush(self) -> None:
        """Read back every pending check and judge each in turn; the queue
        is empty after, whether a judge raised or not.  One pending check
        reads as it would alone; more read one stacked vector at the site
        ``collection_checks``.  With the profiler ranges on, the flush is
        the range ``checks[<member>,...].update`` holding
        ``check.collection_checks``.  Nothing pending: nothing runs."""
        if not self.pending:
            return
        if _telemetry.ANNOTATE:
            with _telemetry.span(f"checks[{','.join(self.members)}].update"):
                with _telemetry.span("check.collection_checks"):
                    return self._flush()
        self._flush()

    def _flush(self) -> None:
        requests, self.pending, self.members = self.pending, [], []
        _stats.count_stacked_checks(len(requests))
        if len(requests) == 1:
            values = [_read_alone(requests[0])]
        else:
            values = _read_stacked(requests)
        for request, value in zip(requests, values):
            request.judge(value)


_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def _read_stacked(requests: Sequence[_Request]) -> List[Any]:
    """The host values of each of ``requests`` from one read back: one
    ``aminmax`` for each tensor read (tensors on the same memory with the
    same shape, strides and dtype are one), each extremum cast to its
    check's dtype as :func:`bounds` casts it, every flag, stacked in the
    widest of their dtypes (a widening cast, so exact)."""
    parts: List[torch.Tensor] = []
    extrema: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
    at: Dict[Any, int] = {}  # (tensor, dtype) -> index of its minimum in parts
    reads: List[Tuple[List[int], Optional[torch.dtype]]] = []
    for request in requests:
        if request.flag is not None:
            reads.append(([len(parts)], None))
            parts.append(request.flag)
            continue
        dtype = _promoted(request.tensors)
        index: List[int] = []
        for t in request.tensors:
            same = (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)
            i = at.get((same, dtype))
            if i is None:
                if same not in extrema:
                    extrema[same] = torch.aminmax(t)
                i = at[(same, dtype)] = len(parts)
                parts.extend(m.to(dtype) for m in extrema[same])
            index += [i, i + 1]
        reads.append((index, dtype))
    wide = _promoted(parts)
    stacked = torch.stack([p if p.dtype == wide else p.to(wide) for p in parts])
    host = _stats.readback("collection_checks", _numpy, stacked)
    return [
        bool(host[index[0]]) if dtype is None else host[index].astype(_NUMPY[dtype])
        for index, dtype in reads
    ]


def check_index_ranges(
    pairs: Sequence[Tuple[torch.Tensor, str]], upper: Optional[int], site: str
) -> None:
    """Range-check several class-index tensors with one read back for all
    of them; raises for the first one outside ``[0, upper)``, in order
    (the JAX scatters drop such indices where torch's raise).  ``site``
    names the ``check.<site>`` span and the read back."""
    if upper is None or not value_checks_enabled():
        return
    if _telemetry.ANNOTATE:
        with _telemetry.span("check." + site):
            return _index_ranges(pairs, upper, site)
    _index_ranges(pairs, upper, site)


def _index_ranges(
    pairs: Sequence[Tuple[torch.Tensor, str]], upper: int, site: str
) -> None:
    pairs = [(v, n) for v, n in pairs if v.numel()]
    if pairs:
        names = [n for _, n in pairs]
        value_check(site, partial(_judge_index_ranges, names, upper), *(v for v, _ in pairs))


def _judge_index_ranges(names: Sequence[str], upper: int, vals: np.ndarray) -> None:
    for i, name in enumerate(names):
        lo, hi = vals[2 * i], vals[2 * i + 1]
        if lo < 0 or hi >= upper:
            raise ValueError(
                f"{name} values should be in [0, {upper}), got min "
                f"{int(lo)} max {int(hi)}."
            )
