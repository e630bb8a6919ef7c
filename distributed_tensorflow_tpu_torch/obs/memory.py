"""Device-memory accounting: who is occupying HBM, by name.

The serving and training stacks allocate a handful of large, long-lived
device residencies — model params, AdamW slots, the decode engine's
slot-table KV cache, the prefix-cache page pool, the stale-mode gradient
ring, host staging buffers — and the contention between them is exactly
what ``ckpt.restore_serving_state(release_opt_state=True)`` exists to
manage. This module makes that contention *visible*: components register
named byte reservations at allocation time (sizes computed from array
shapes, so the accounting costs a dict write, never a device sync), and
the registry reconciles the accounted total against
``torch.cuda.memory_stats(i)`` where the backend reports it.

Degradation contract: memory statistics are a GPU feature — the CPU
reports none. The registry treats every per-device failure as
"unreported" and falls back to accounted-only totals, so ``GET /memz``
answers on every backend and reconciliation applies only where the runtime
actually reports.

Threading: one small lock orders every method; no call ever re-enters a
caller's lock (engines call ``register`` while holding their own buffer
locks — the registry must never call back out).
"""

from __future__ import annotations

import threading

import torch

__all__ = [
    "MemoryRegistry",
    "default_registry",
    "reset_default_registry",
    "tree_nbytes",
]


def tree_nbytes(tree) -> int:
    """Total bytes of every tensor/array leaf in ``tree`` (dicts, lists and
    tuples of torch tensors or numpy arrays). Shape-derived: never syncs."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0) or 0)


class _TorchDevice:
    """One local device as the registry reads it: ``platform`` and a
    ``memory_stats()`` that answers None where nothing is reported (CPU)."""

    def __init__(self, index: int | None):
        self.index = index
        self.platform = "cpu" if index is None else "gpu"

    def memory_stats(self):
        if self.index is None:
            return None
        stats = torch.cuda.memory_stats(self.index)
        return {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(self.index).total_memory,
        }


def _local_devices() -> list:
    if torch.cuda.is_available():
        return [_TorchDevice(i) for i in range(torch.cuda.device_count())]
    return [_TorchDevice(None)]


class MemoryRegistry:
    """Named byte reservations + device reconciliation.

    ``register`` SETS a component's reservation (idempotent re-registration
    — a rebuilt engine overwrites its dead predecessor's entry instead of
    double counting); ``add`` grows one (staging buffers accrete);
    ``release`` removes one, accumulating the freed bytes into a
    ``released`` ledger so a restore that drops the AdamW slots leaves an
    auditable trail in ``/memz`` rather than just a smaller number.

    ``devices_fn`` defaults to the local CUDA devices (one unreported CPU
    row without a card) and exists so tests can reconcile against stub
    devices.
    """

    # Shared mutable state; every access is ordered by self._lock (the
    # sanitize_races soak can watch these when a test wraps an instance).
    _RACETRACE_ATTRS = ("_reserved", "_released", "_dtypes", "_fp32")

    def __init__(self, devices_fn=None):
        self._lock = threading.Lock()
        self._reserved: dict[str, int] = {}
        self._released: dict[str, int] = {}
        # Quantized-serving ledger: the storage dtype a component
        # declared and what its payload WOULD cost at fp32, so /memz can
        # answer "what did int8 buy me" per component without re-deriving
        # shapes.
        self._dtypes: dict[str, str] = {}
        self._fp32: dict[str, int] = {}
        self._devices_fn = devices_fn

    # -------------------------------------------------------- bookkeeping

    def register(self, component: str, nbytes: int, *,
                 dtype: str | None = None,
                 fp32_nbytes: int | None = None) -> None:
        """Set ``component``'s reservation to ``nbytes`` (absolute).

        ``dtype`` / ``fp32_nbytes`` are optional quantization metadata:
        the storage dtype and the fp32-equivalent byte count of the same
        payload (``/memz`` reports ``fp32_nbytes - nbytes`` as
        ``bytes_saved_vs_fp32``)."""
        with self._lock:
            key = str(component)
            self._reserved[key] = int(nbytes)
            if dtype is not None:
                self._dtypes[key] = str(dtype)
            else:
                self._dtypes.pop(key, None)
            if fp32_nbytes is not None:
                self._fp32[key] = int(fp32_nbytes)
            else:
                self._fp32.pop(key, None)

    def add(self, component: str, nbytes: int) -> None:
        """Grow ``component``'s reservation by ``nbytes``."""
        with self._lock:
            key = str(component)
            self._reserved[key] = self._reserved.get(key, 0) + int(nbytes)

    def register_tree(self, component: str, tree, *,
                      dtype: str | None = None,
                      fp32_nbytes: int | None = None) -> int:
        """``register`` with bytes summed from an array pytree; returns the
        byte count so callers can log it."""
        n = tree_nbytes(tree)
        self.register(component, n, dtype=dtype, fp32_nbytes=fp32_nbytes)
        return n

    def release(self, component: str, nbytes: int | None = None) -> int:
        """Drop ``component``'s reservation (or ``nbytes`` of it) and
        record the freed bytes in the ``released`` ledger. Returns the
        bytes actually released (0 for an unknown component)."""
        with self._lock:
            key = str(component)
            held = self._reserved.get(key, 0)
            freed = held if nbytes is None else min(int(nbytes), held)
            if freed <= 0 and held == 0:
                return 0
            remaining = held - freed
            if remaining > 0:
                self._reserved[key] = remaining
            else:
                self._reserved.pop(key, None)
            self._released[key] = self._released.get(key, 0) + freed
            return freed

    def components(self) -> dict[str, int]:
        with self._lock:
            return dict(sorted(self._reserved.items()))

    def accounted_bytes(self) -> int:
        with self._lock:
            return sum(self._reserved.values())

    # ----------------------------------------------------- reconciliation

    def _devices(self):
        if self._devices_fn is not None:
            return self._devices_fn()
        return _local_devices()

    def device_stats(self) -> list[dict]:
        """One row per local device: ``memory_stats()`` where the backend
        reports it, ``reported: False`` where it doesn't (CPU). Failures
        degrade per device — one bad device never hides the others."""
        rows = []
        try:
            devices = self._devices()
        except Exception:  # noqa: BLE001 — no backend at all: no rows
            return rows
        for i, d in enumerate(devices):
            row = {
                "device": i,
                "platform": getattr(d, "platform", "unknown"),
                "reported": False,
            }
            stats_fn = getattr(d, "memory_stats", None)
            if callable(stats_fn):
                try:
                    stats = stats_fn()
                except Exception:  # noqa: BLE001 — backend quirk != outage
                    stats = None
                if stats:
                    row["reported"] = True
                    row["bytes_in_use"] = int(stats.get("bytes_in_use", 0))
                    limit = stats.get(
                        "bytes_limit", stats.get("bytes_reservable_limit", 0)
                    )
                    row["bytes_limit"] = int(limit or 0)
            rows.append(row)
        return rows

    def reconcile(self) -> dict:
        """Accounted vs backend-reported totals + a headroom estimate.

        ``ratio`` is accounted/reported (None when nothing reports — the
        CPU fallback); ``headroom_bytes`` is limit - in_use summed over
        reporting devices, or None."""
        devices = self.device_stats()
        reporting = [d for d in devices if d["reported"]]
        accounted = self.accounted_bytes()
        out = {
            "accounted_bytes": accounted,
            "devices_reporting": len(reporting),
            "devices_total": len(devices),
            "reported_bytes_in_use": None,
            "headroom_bytes": None,
            "ratio": None,
        }
        if reporting:
            in_use = sum(d["bytes_in_use"] for d in reporting)
            limit = sum(d["bytes_limit"] for d in reporting)
            out["reported_bytes_in_use"] = in_use
            if limit:
                out["headroom_bytes"] = max(limit - in_use, 0)
            if in_use:
                out["ratio"] = accounted / in_use
        return out

    def snapshot(self) -> dict:
        """The ``GET /memz`` body: per-component reservations, the freed
        ledger, quantization metadata (storage dtype + bytes saved vs an
        fp32 baseline, per component and total), per-device stats, and the
        reconciliation digest."""
        with self._lock:
            reserved = dict(sorted(self._reserved.items()))
            released = dict(sorted(self._released.items()))
            dtypes = dict(sorted(self._dtypes.items()))
            saved = {
                key: self._fp32[key] - self._reserved.get(key, 0)
                for key in sorted(self._fp32)
            }
        return {
            "components": reserved,
            "released": released,
            "component_dtypes": dtypes,
            "bytes_saved_vs_fp32": saved,
            "bytes_saved_vs_fp32_total": sum(saved.values()),
            "devices": self.device_stats(),
            **self.reconcile(),
        }


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: MemoryRegistry | None = None


def default_registry() -> MemoryRegistry:
    """Process-wide registry: engines/ckpt/train register here unless a
    caller supplies their own, so one serving process's ``/memz`` sees
    every footprint without plumbing a handle through each layer."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MemoryRegistry()
        return _DEFAULT


def reset_default_registry() -> None:
    """Swap in a fresh default (tests isolate their accounting with it)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MemoryRegistry()
