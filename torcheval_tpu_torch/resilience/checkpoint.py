"""Durable checkpoint/resume for streaming evals (the port of
``torcheval_tpu/resilience/checkpoint.py``).

An eval that streams millions of batches loses *all* accumulated metric
state when the host is preempted.  This module makes that state durable
with the classic atomic-write recipe:

- payload = pickle of ``{"state": <flat mapping>, "cursor": {...}}``:
  ``state`` is a collection's ``state_dict()`` (the flat
  ``"{member}/{state}"`` mapping), every tensor copied to host numpy, so
  the payload holds only numpy arrays, ints and strs, never a torch
  object or a device;
- written to ``ckpt-<generation>.bin.tmp``, flushed, ``os.fsync``-ed,
  then ``os.rename``-d into place (atomic on POSIX);
- a sidecar manifest ``ckpt-<generation>.manifest.json`` (the same
  tmp+fsync+rename, written *after* the data file) records the payload's
  SHA-256, byte length and the cursor, so a reader can validate without
  unpickling.

The layout is the JAX package's: a checkpoint written by either package
loads in the other (``convert.state_from_jax`` turns a loaded ``state``
into tensors for ``load_state_dict``).

``load_latest`` walks generations newest-first: a checkpoint whose
manifest is missing or unreadable, or whose data hash or length
mismatches, is *quarantined* (both files renamed with a ``.corrupt``
suffix, a ``checkpoint``/``quarantine`` telemetry event emitted) and the
previous generation is tried: a torn write never poisons resume, it just
costs one generation of progress.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import shutil
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

import torch

from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.telemetry import events as _telemetry

_DATA_RE = re.compile(r"^ckpt-(\d{8})\.bin$")
_MANIFEST_VERSION = 1
_NAMESPACE_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]")

# Sentinel returned by _load_one for a generation whose files vanished
# between the directory listing and the read — a concurrent _prune, not
# corruption.  Distinct from None (validation failure → quarantine).
_CONCURRENTLY_PRUNED = object()


@dataclass
class Checkpoint:
    """One loaded-and-validated checkpoint generation."""

    generation: int
    path: str
    state: Dict[str, np.ndarray]
    cursor: Dict[str, int]
    nbytes: int


@dataclass
class CheckpointBlob:
    """One generation as wire-ready bytes: the raw pickled payload plus
    its manifest (sha256/nbytes/cursor).  This is what the serve
    cluster streams p2p during a live migration — the manifest travels
    WITH the bytes so the importer can prove the transfer intact before
    any state is trusted, and the generation number fences stale
    owners (a replayed older blob can never shadow a newer one)."""

    generation: int
    manifest: Dict[str, Any]
    payload: bytes


def _to_host(value: Any) -> Any:
    """A state leaf as host numpy: a tensor is copied off its device; a
    list or dict of tensors (a buffer state) keeps its shape."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (list, tuple)):
        return [_to_host(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    return np.asarray(value)


def _fsync_write(path: str, data: bytes) -> None:
    """tmp-file + flush + fsync + atomic rename into ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.rename(tmp, path)


class CheckpointManager:
    """Generation-numbered atomic checkpoints in one directory.

    ``keep`` bounds disk use: after each successful save, valid
    generations beyond the newest ``keep`` are deleted (quarantined
    ``.corrupt`` files are left for post-mortems).
    """

    def __init__(self, directory: str, *, keep: int = 2) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    # -- scoping ---------------------------------------------------------
    def namespace(self, name: str) -> "CheckpointManager":
        """A child manager over the subdirectory ``name`` (sanitized to
        filename-safe characters), inheriting ``keep``.  Namespaces are
        how the serve layer keys per-tenant spill state: each tenant's
        generations live in their own subtree, so one tenant's
        :meth:`delete_all` on close cannot touch a sibling's."""
        safe = _NAMESPACE_SAFE_RE.sub("_", name)
        if not safe:
            raise ValueError(f"namespace name sanitizes to empty: {name!r}")
        return CheckpointManager(
            os.path.join(self.directory, safe), keep=self.keep
        )

    def delete_all(self) -> None:
        """Remove this manager's directory tree — generations,
        quarantined ``.corrupt`` files, and child namespaces.  Siblings
        of this directory are never touched.  Idempotent; errors from
        concurrent cleanup are swallowed like :meth:`_prune`'s."""
        shutil.rmtree(self.directory, ignore_errors=True)

    # -- paths -----------------------------------------------------------
    def _data_path(self, generation: int) -> str:
        return os.path.join(self.directory, f"ckpt-{generation:08d}.bin")

    def _manifest_path(self, generation: int) -> str:
        return os.path.join(
            self.directory, f"ckpt-{generation:08d}.manifest.json"
        )

    def generations(self) -> List[int]:
        """Generation numbers with a data file present, ascending."""
        out = []
        for name in os.listdir(self.directory):
            m = _DATA_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # -- write -----------------------------------------------------------
    def save(
        self,
        state: Mapping[str, Any],
        cursor: Mapping[str, int],
    ) -> str:
        """Atomically persist one generation; returns the data path.

        ``state`` is the collection's flat ``state_dict()`` mapping;
        every tensor is copied to host numpy (all of them first, then one
        pickle), so the payload is device-free and bit-exact on reload.
        """
        t0 = time.monotonic()
        host_state = {k: _to_host(v) for k, v in state.items()}
        payload = pickle.dumps(
            {"state": host_state, "cursor": dict(cursor)},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        gens = self.generations()
        generation = (gens[-1] + 1) if gens else 0
        data_path = self._data_path(generation)

        if _faults.ENABLED:
            rule = _faults.fire(
                "checkpoint.write",
                generation=generation,
                nbytes=len(payload),
            )
            if rule is not None and rule.action == "tear":
                # Simulate a crash that left a torn data file on disk
                # (power loss after a non-atomic writer, fsync lost):
                # the manifest records the full payload's hash, so
                # load_latest must quarantine this generation.
                with open(data_path, "wb") as fh:
                    fh.write(payload[: rule.offset])
                self._write_manifest(generation, payload, cursor)
                raise _faults.InjectedFault(
                    "checkpoint.write",
                    f"torn checkpoint write at byte {rule.offset}",
                )

        _fsync_write(data_path, payload)
        self._write_manifest(generation, payload, cursor)
        self._prune()
        if _telemetry.ENABLED:
            _telemetry.record_checkpoint(
                "save",
                data_path,
                generation,
                len(payload),
                time.monotonic() - t0,
            )
        return data_path

    def _write_manifest(
        self, generation: int, payload: bytes, cursor: Mapping[str, int]
    ) -> None:
        manifest = {
            "version": _MANIFEST_VERSION,
            "generation": generation,
            "sha256": hashlib.sha256(payload).hexdigest(),
            "nbytes": len(payload),
            "cursor": dict(cursor),
        }
        _fsync_write(
            self._manifest_path(generation),
            json.dumps(manifest, sort_keys=True).encode("utf-8"),
        )

    def _prune(self) -> None:
        for generation in self.generations()[: -self.keep]:
            for path in (
                self._data_path(generation),
                self._manifest_path(generation),
            ):
                try:
                    os.remove(path)
                except OSError:  # pragma: no cover - concurrent cleanup
                    pass

    # -- read ------------------------------------------------------------
    def load_latest(self) -> Optional[Checkpoint]:
        """Newest checkpoint that validates; corrupt generations are
        quarantined and older ones tried.  None when nothing valid.

        Tolerates a concurrent writer pruning while this reader walks:
        a NON-newest generation whose files are gone by read time was
        concurrently pruned and is skipped without quarantine (only the
        newest generation can legitimately be torn — data is written
        before manifest, and _prune never touches the newest ``keep``).
        If every listed generation vanished mid-walk the stale listing
        is refreshed once before giving up."""
        for attempt in range(2):
            gens = self.generations()
            if not gens:
                return None
            pruned_under_us = 0
            for generation in reversed(gens):
                t0 = time.monotonic()
                loaded = self._load_one(
                    generation, newest=(generation == gens[-1])
                )
                if loaded is _CONCURRENTLY_PRUNED:
                    pruned_under_us += 1
                    continue
                if loaded is None:
                    self._quarantine(generation)
                    continue
                if _telemetry.ENABLED:
                    _telemetry.record_checkpoint(
                        "restore",
                        loaded.path,
                        generation,
                        loaded.nbytes,
                        time.monotonic() - t0,
                    )
                return loaded
            if pruned_under_us == 0 or attempt == 1:
                return None
        return None  # pragma: no cover - loop always returns

    def _load_one(self, generation: int, *, newest: bool = True):
        data_path = self._data_path(generation)
        try:
            with open(self._manifest_path(generation), "rb") as fh:
                manifest = json.loads(fh.read().decode("utf-8"))
            with open(data_path, "rb") as fh:
                payload = fh.read()
        except OSError:
            # Missing files on an older generation mean a concurrent
            # _prune won the race, not corruption; the newest generation
            # has no such excuse (save order is data-then-manifest).
            if not newest and not (
                os.path.exists(data_path)
                or os.path.exists(self._manifest_path(generation))
            ):
                return _CONCURRENTLY_PRUNED
            return None
        except (ValueError, UnicodeDecodeError):
            return None
        if (
            len(payload) != manifest.get("nbytes")
            or hashlib.sha256(payload).hexdigest() != manifest.get("sha256")
        ):
            return None
        try:
            record = pickle.loads(payload)
        except Exception:  # noqa: BLE001 - hash passed but unpicklable
            return None
        return Checkpoint(
            generation=generation,
            path=data_path,
            state=record["state"],
            cursor=dict(record["cursor"]),
            nbytes=len(payload),
        )

    # -- p2p streaming ---------------------------------------------------
    def export_latest(self) -> Optional[CheckpointBlob]:
        """The newest *valid* generation as a wire-ready
        :class:`CheckpointBlob` (payload bytes + manifest), for
        streaming over a p2p transport during a live migration.  Walks
        newest-first like :meth:`load_latest` but leaves quarantine
        policy to the readers; returns None when nothing validates."""
        for generation in reversed(self.generations()):
            try:
                with open(self._manifest_path(generation), "rb") as fh:
                    manifest = json.loads(fh.read().decode("utf-8"))
                with open(self._data_path(generation), "rb") as fh:
                    payload = fh.read()
            except (OSError, ValueError, UnicodeDecodeError):
                continue
            if (
                len(payload) != manifest.get("nbytes")
                or hashlib.sha256(payload).hexdigest()
                != manifest.get("sha256")
            ):
                continue
            return CheckpointBlob(
                generation=generation,
                manifest=manifest,
                payload=payload,
            )
        return None

    def import_blob(self, blob: CheckpointBlob) -> bool:
        """Install a streamed generation received over the wire.

        The payload is validated against the manifest it traveled with
        (sha256 + byte length) BEFORE anything durable is trusted:

        * valid → written with the same data-then-manifest fsync dance
          as :meth:`save`, so :meth:`load_latest` resumes from it.
          Idempotent: re-importing a generation whose local files
          already validate is a no-op (shared-store deployments see the
          owner's own save under the same name).
        * torn/corrupt transfer → the bytes are preserved under
          ``.corrupt`` paths for the post-mortem (never touching any
          resident generation's files), a ``checkpoint``/``quarantine``
          telemetry event fires, and False is returned — the importer
          must not resume from it.
        """
        manifest = dict(blob.manifest)
        generation = int(manifest.get("generation", blob.generation))
        payload = blob.payload
        valid = (
            generation >= 0
            and len(payload) == manifest.get("nbytes")
            and hashlib.sha256(payload).hexdigest()
            == manifest.get("sha256")
        )
        if not valid:
            quarantine_path = (
                self._data_path(max(generation, 0)) + ".corrupt"
            )
            try:
                with open(quarantine_path, "wb") as fh:
                    fh.write(payload)
            except OSError:  # pragma: no cover - disk gone mid-import
                pass
            if _telemetry.ENABLED:
                _telemetry.record_checkpoint(
                    "quarantine", quarantine_path, max(generation, 0), 0, 0.0
                )
            return False
        if self._load_one(generation, newest=False) not in (
            None,
            _CONCURRENTLY_PRUNED,
        ):
            return True
        t0 = time.monotonic()
        _fsync_write(self._data_path(generation), payload)
        _fsync_write(
            self._manifest_path(generation),
            json.dumps(manifest, sort_keys=True).encode("utf-8"),
        )
        self._prune()
        if _telemetry.ENABLED:
            _telemetry.record_checkpoint(
                "save",
                self._data_path(generation),
                generation,
                len(payload),
                time.monotonic() - t0,
            )
        return True

    def _quarantine(self, generation: int) -> None:
        data_path = self._data_path(generation)
        for path in (data_path, self._manifest_path(generation)):
            if os.path.exists(path):
                try:
                    os.rename(path, path + ".corrupt")
                except OSError:  # pragma: no cover - concurrent cleanup
                    pass
        if _telemetry.ENABLED:
            _telemetry.record_checkpoint(
                "quarantine", data_path + ".corrupt", generation, 0, 0.0
            )
