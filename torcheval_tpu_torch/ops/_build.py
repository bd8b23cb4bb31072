"""Build and load the port's CUDA kernels, and count their launches.

Every ``ops/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into ONE shared library with a plain C interface, loaded with ``ctypes``.
No source includes PyTorch's headers, which keeps a build to seconds.
Each ``.cu`` compiles to an object in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links them.

The library lands in ``ops/_build/`` under a name keyed by a hash of the
sources and flags, so a second run loads it without rebuilding.  The
build happens at the first launch, never at import.  A missing ``nvcc``
or a failed build raises with the compiler's output; nothing falls back.

Counters: each kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel (:func:`count_launch`), and each plain version adds
one to ``PLAIN_CALLS[name]`` (:func:`count_plain`), so a run can show
which path it took.  Both take a lock: the ranks of a ``LocalWorld`` are
threads that launch at once, and no increment may be lost.  The first
build is serialised the same way, so ranks that reach it together build
the library once.  A CUDA graph capture records launches and runs none:
under :func:`recording` the capturing thread's launches go to the
capture's own counter, and each replay adds them (:func:`count_replay`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# The H100's SM count: the launch plans' default where no card is asked.
H100_SMS = 132

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()
_COUNT_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double

# C entry point -> argument types.  Every entry returns cudaGetLastError().
_SIGNATURES: Dict[str, tuple] = {
    # queries, stride_row, stride_col, rq, n, tables, cap, negate, group_rows,
    # vec16, smem_tables, fixed_top, blocks_per_group, out, stream
    "rank_sum_counts_launch": (_P, _LL, _LL, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # thresholds, hits, rows, n, chunk, chunks, vec, scratch, out, stream
    "auc_scan_launch": (_P, _P, _I, _LL, _I, _I, _I, _P, _P, _P),
    # target, target_wide, pred, pred_wide, n, w, vec, blocks, slab, stream
    "cm_slab_launch": (_P, _I, _P, _I, _LL, _I, _I, _I, _P, _P),
    # queries, stride_row, stride_col, rq, n, tables, cap, group_rows, vec16,
    # smem_tables, fixed_top, blocks_per_group, hist, stream
    "rank_hist_counts_launch": (_P, _LL, _LL, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # scores, s_row, s_col, hits, h_row, h_col, rows, n, thresholds, t,
    # group_rows, vec, smem, private_route, blocks, scratch, cell_sums,
    # num_tp, num_fp, num_pos, num_total, stream
    "binned_count_launch": (
        _P, _LL, _LL, _P, _LL, _LL, _I, _I, _P, _I,
        _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
    ),
    # scores, pred, target, weight, sids, n, thresholds, plan, plan_bytes, out, stream
    "mega_counts_launch": (_P, _P, _P, _P, _P, _LL, _P, _P, _I, _P, _P),
    # a, b, a_lens, b_lens, n, wa, wb, scratch, scratch_blocks, out, stream
    "wavefront_launch": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P),
    # scores, s_row, s_col, hits, h_row, h_col, weights, rows, n, thresholds,
    # t, warps, row_warps, smem_hist, ranges, per_range, scratch, w_tp, w_fp,
    # w_pos, stream
    "binned_wcount_launch": (
        _P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _P,
        _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
    ),
    # weights, n, bits, stream
    "binned_wcount_range_launch": (_P, _LL, _P, _P),
    # logits, s0, s1, seq, rows, vocab, dtype, target, target_wide, out, stream
    "token_nll_launch": (_P, _LL, _LL, _I, _I, _I, _I, _P, _I, _P, _P),
    # scores, s_row, s_col, hits, h_row, h_col, weights, rows, n, thresholds,
    # t, scale, quantum, window, ranges, per_range, smem_thr, hist, w_tp,
    # w_fp, w_pos, stream
    "binned_wcount_fixed_launch": (
        _P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _P,
        _I, _D, _D, _I, _I, _I, _I, _P, _P, _P, _P, _P,
    ),
}


def reset_counts() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()
        PLAIN_CALLS.clear()


_RECORDING = threading.local()


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` (recorded, not counted, while this
    thread captures a CUDA graph under :func:`recording`)."""
    recorder = getattr(_RECORDING, "counter", None)
    if recorder is not None:
        recorder[name] += 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


@contextmanager
def recording() -> Iterator[Counter]:
    """Divert this thread's :func:`count_launch` calls into a fresh
    ``Counter`` for the duration: a CUDA graph capture runs no kernel, so
    its launches count when the graph replays (:func:`count_replay`)."""
    recorder: Counter = Counter()
    previous = getattr(_RECORDING, "counter", None)
    _RECORDING.counter = recorder
    try:
        yield recorder
    finally:
        _RECORDING.counter = previous


def count_replay(launches: Counter) -> None:
    """One replay of a captured graph: the launches its capture recorded."""
    with _COUNT_LOCK:
        LAUNCHES.update(launches)


def count_plain(name: str) -> None:
    """One call of the plain version of kernel ``name``."""
    with _COUNT_LOCK:
        PLAIN_CALLS[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA kernels of torcheval_tpu_torch are built from "
        f"{CSRC} at first use and need the CUDA toolkit."
    )


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libtorcheval_tpu_torch_{digest.hexdigest()[:16]}.so"


def _run(procs) -> None:
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a library of these sources exists;
    returns its path."""
    target = _library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append(
                (cmd, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
            )
            objects.append(str(obj))
        _run(procs)
        lib = Path(tmp) / target.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *objects]
        _run([(cmd, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))])
        os.replace(lib, target)  # atomic: a concurrent build loses nothing
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call; callers that
    arrive during the build wait for it)."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {err} "
            "(a cudaError_t value of the CUDA runtime)"
        )


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count
