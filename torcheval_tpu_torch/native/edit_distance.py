"""ctypes loader for the native batched Levenshtein distance.

Compiles ``edit_distance.cpp`` once per environment with the system C++
compiler into a cached shared object (``_build/`` next to this file, named
by a hash of the source), loads it with ctypes, and exposes one batch entry
point.  When no compiler works (no ``g++``/``c++``/``clang++`` on the
host) the pure-Python two-row dynamic program below stands in: identical
results, just slower.  :func:`backend` says which of the two runs."""

import ctypes
import hashlib
import logging
import os
import subprocess
import sysconfig
import threading
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "edit_distance.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_build_dir(), f"editdist_{digest}{suffix}")


def _compile() -> str:
    so = _so_path()
    if os.path.exists(so):
        return so
    # Compile to a per-process temp name and rename into place atomically:
    # concurrent importers (data-parallel workers) may race here, and an
    # interrupted build must never leave a truncated .so at the final path.
    tmp = f"{so}.tmp.{os.getpid()}"
    for cxx in ("g++", "c++", "clang++"):
        cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.rename(tmp, so)
            return so
        except (OSError, subprocess.SubprocessError) as e:
            last_error = e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    raise RuntimeError(f"no working C++ compiler: {last_error}")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_FAILED
    # Double-checked: the unlocked read is re-checked under _LOCK before
    # any write, and both names are stable once the with-block completes.
    # tpulint: disable=TPU006,TPU009 -- double-checked fast path; re-checked
    if _LIB is not None or _LOAD_FAILED:
        return _LIB  # tpulint: disable=TPU006 -- double-checked fast path
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        try:
            lib = ctypes.CDLL(_compile())
            lib.tvt_levenshtein_batch.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.tvt_levenshtein_batch.restype = None
            _LIB = lib
        except (OSError, RuntimeError) as e:  # pragma: no cover - env specific
            log.warning(
                "native edit distance unavailable (%s); using the pure-Python "
                "version",
                e,
            )
            _LOAD_FAILED = True
    # tpulint: disable=TPU006 -- stable once the with-block above completes
    return _LIB


def backend() -> str:
    """``"c++"`` when :func:`edit_distance_batch` runs the compiled DP
    (building it now if need be), ``"python"`` when it runs the stand-in."""
    return "python" if _load() is None else "c++"


def _edit_distance_py(a: Sequence[int], b: Sequence[int]) -> int:
    """Two-row DP, the same algorithm as the C++ one."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        diag, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            up = row[j]
            row[j] = min(diag if ca == cb else diag + 1, up + 1, row[j - 1] + 1)
            diag = up
    return row[-1]


def _pack(seqs: List[List[int]]):
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    flat = np.fromiter(
        (t for s in seqs for t in s), dtype=np.int32, count=int(offsets[-1])
    )
    return flat, offsets


def edit_distance_batch(
    a_seqs: List[List[int]], b_seqs: List[List[int]]
) -> np.ndarray:
    """Levenshtein distance for each ``(a_seqs[i], b_seqs[i])`` pair of
    token-id sequences; one native call for the whole batch."""
    if len(a_seqs) != len(b_seqs):
        raise ValueError(
            f"Expected equally many sequences, got {len(a_seqs)} and "
            f"{len(b_seqs)}."
        )
    lib = _load()
    if lib is None:
        return np.asarray(
            [_edit_distance_py(a, b) for a, b in zip(a_seqs, b_seqs)],
            dtype=np.int64,
        )
    a_flat, a_off = _pack(a_seqs)
    b_flat, b_off = _pack(b_seqs)
    out = np.zeros(len(a_seqs), dtype=np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.tvt_levenshtein_batch(
        a_flat.ctypes.data_as(i32p),
        a_off.ctypes.data_as(i64p),
        b_flat.ctypes.data_as(i32p),
        b_off.ctypes.data_as(i64p),
        len(a_seqs),
        out.ctypes.data_as(i64p),
    )
    return out
