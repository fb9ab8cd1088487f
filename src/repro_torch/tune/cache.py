"""Persistent JSON schedule cache (the port of ``repro.tune.cache``).

One file holds every tuned schedule, keyed by
``op/shape/dtype/device-kind`` (see :meth:`OpSpec.key`), where the device
kind is the CUDA card's name (``torch.cuda.get_device_name()``) or
``cpu``.  The default location is ``$REPRO_TORCH_TUNE_CACHE`` if set,
else ``~/.cache/repro_torch/schedules.json``: never the JAX package's
file.  Pass an explicit path to keep a per-project cache, pre-populated
offline with ``python -m repro_torch.tune``.

File format (version 1)::

    {"version": 1,
     "schedules": {"matmul/m8n4096k4096/bfloat16/NVIDIA H100 80GB HBM3":
                   {...Schedule...},
                   "conv2d/x56y56c128k256f3x3s1/bfloat16/NVIDIA H100 ...":
                   {...Schedule...}}}

The conv keys carry the stride (``s1``), as JAX's do.

Writes are read-modify-write through an adjacent temp file + ``os.replace``
so concurrent tuners cannot truncate each other's entries.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

from repro_torch.tune.schedule import OpSpec, Schedule

SCHEMA_VERSION = 1


def default_cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "schedules.json")


def device_kind() -> str:
    """Device tag used in cache keys: the CUDA card's name where there is
    one, else ``cpu``, so a schedule tuned on one card is never read as
    another's."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


class ScheduleCache:
    """Dict-of-Schedules with lazy load and atomic persistence."""

    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()
        self._loaded: dict[str, Schedule] | None = None

    # -- IO -------------------------------------------------------------------

    def _quarantine(self, why: str) -> None:
        """Move the unreadable file aside to ``<path>.corrupt`` so the
        next flush rebuilds a clean cache without destroying the
        evidence (a second corrupt file overwrites the first — the
        newest specimen is the one worth inspecting)."""
        quarantined = self.path + ".corrupt"
        try:
            os.replace(self.path, quarantined)
        except OSError:
            return              # raced away or unwritable dir: nothing to do
        warnings.warn(
            f"schedule cache {self.path} is corrupt ({why}); quarantined "
            f"to {quarantined} and rebuilding — retune with "
            f"`python -m repro_torch.tune` to repopulate")

    def _read_file(self) -> dict[str, Schedule]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except OSError:
            return {}           # no cache yet: cold start, not corruption
        except json.JSONDecodeError as e:
            self._quarantine(f"invalid JSON: {e}")
            return {}
        if not isinstance(raw, dict):
            self._quarantine(f"expected an object, got {type(raw).__name__}")
            return {}
        if raw.get("version") != SCHEMA_VERSION:
            return {}
        out: dict[str, Schedule] = {}
        for key, entry in raw.get("schedules", {}).items():
            try:
                # keep on-disk provenance (measured/analytic) intact;
                # lookup() tags what it hands out as "cache"
                out[key] = Schedule.from_json(entry)
            except (KeyError, ValueError, TypeError):
                continue  # skip corrupt entries, keep the rest
        return out

    def _entries(self) -> dict[str, Schedule]:
        if self._loaded is None:
            self._loaded = self._read_file()
        return self._loaded

    def _flush(self, entries: dict[str, Schedule]) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        payload = {"version": SCHEMA_VERSION,
                   "schedules": {k: s.to_json()
                                 for k, s in sorted(entries.items())}}
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(self.path)),
            suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- API ------------------------------------------------------------------

    def lookup(self, spec: OpSpec, device: str | None = None
               ) -> Schedule | None:
        hit = self._entries().get(spec.key(device or device_kind()))
        return hit.with_source("cache") if hit is not None else None

    def store(self, schedule: Schedule, device: str | None = None) -> str:
        """Persist (merging with whatever is on disk) and return the key."""
        key = schedule.spec.key(device or device_kind())
        entries = self._read_file()   # re-read: merge concurrent writers
        entries[key] = schedule
        self._flush(entries)
        self._loaded = entries
        return key

    def keys(self) -> list[str]:
        return sorted(self._entries())
