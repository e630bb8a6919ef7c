"""Checkpoints over ``torch.save`` files (port of ``ckpt/checkpoint.py``).

One file per step, ``<dir>/step_<step>.pt``, holding at least ``{"step",
"params"}`` with ``params`` a model ``state_dict`` on the CPU. Writes go to
a temporary name and are renamed into place, so a reader never sees half a
file. :func:`save` writes params only; the training :class:`Checkpointer`
adds the optimizer state, the stale gradient ring and the generator state
to the same file, so :func:`restore_serving_state` serves a training
checkpoint unchanged.

Importing an orbax checkpoint written by the JAX package needs JAX to read
it and is left to a later slice: convert such params with :mod:`..interop`
and ``save`` them here.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _step_path(directory: Path, step: int) -> Path:
    return directory / f"step_{step:08d}.pt"


def latest_step(directory: str | Path) -> int | None:
    """Newest saved step under ``directory``, or None."""
    d = Path(directory)
    if not d.is_dir():
        return None
    steps = [int(m.group(1)) for p in d.iterdir() if (m := _STEP_FILE.match(p.name))]
    return max(steps, default=None)


def _write(directory: Path, step: int, blob: dict) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    path = _step_path(directory, step)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def _to_device(tree, device, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _to_device(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, copy) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=copy)
    return tree


def _to_cpu(tree):
    """A CPU copy of ``tree`` that shares no storage with it. ``.to("cpu")``
    alone returns a CPU tensor itself, which the next in-place step would
    then change under the writer thread."""
    return _to_device(tree, "cpu", copy=True)


def save(directory: str | Path, step: int, state_dict: dict) -> Path:
    """Write ``state_dict`` (moved to the CPU) as step ``step``."""
    return _write(Path(directory), int(step), {"step": int(step), "params": _to_cpu(state_dict)})


class Checkpointer:
    """Periodic train-state checkpoints with restore-latest.

    ``save`` copies the state to the CPU on the caller's thread (the step
    updates the parameters in place right after) and writes the file on a
    background thread; ``wait`` blocks until the last write is durable.
    The newest ``max_to_keep`` files are kept. Usage::

        ckpt = Checkpointer(dir)
        state, start = ckpt.restore_latest(state, generator=g)  # (state, 0) on a fresh dir
        fit(state, step, data, rng=g, checkpointer=ckpt, ckpt_every=500, ...)
        ckpt.close()
    """

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state, *, generator: torch.Generator | None = None) -> None:
        """Save ``state`` (a :class:`~..train.state.TrainState`) as ``step``,
        with ``generator``'s state when one is given."""
        blob = {
            "step": int(step),
            "params": _to_cpu(state.params),
            "opt_state": _to_cpu(state.opt_state.state_dict()),
            "model_state": _to_cpu(state.model_state),
            "grad_buffer": _to_cpu(state.grad_buffer),
            "buffer_index": state.buffer_index,
            "generator": None if generator is None else generator.get_state(),
        }
        self.wait()
        self._thread = threading.Thread(
            target=self._write_and_prune, args=(int(step), blob),
            name="ckpt-writer", daemon=True)
        self._thread.start()

    def _write_and_prune(self, step: int, blob: dict) -> None:
        try:
            _write(self.directory, step, blob)
            steps = sorted(
                int(m.group(1)) for p in self.directory.iterdir()
                if (m := _STEP_FILE.match(p.name)))
            for old in steps[:-self.max_to_keep]:
                _step_path(self.directory, old).unlink(missing_ok=True)
        except Exception as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def latest_step(self) -> int | None:
        """Newest saved step, counting a save still being written."""
        self.wait()
        return latest_step(self.directory)

    def restore_latest(self, state, *, generator: torch.Generator | None = None):
        """Load the newest checkpoint into ``state`` in place (parameters,
        optimizer state, stale ring, step), its ``model_state`` (BatchNorm
        running statistics) onto the parameters' device, and, when both
        exist, the saved generator state into ``generator``. Returns
        ``(state, step)``; ``(state, 0)`` untouched when there is no
        checkpoint."""
        step = self.latest_step()
        if step is None:
            return state, 0
        blob = torch.load(_step_path(self.directory, step), map_location="cpu",
                          weights_only=True)
        with torch.no_grad():
            for name, p in state.params.items():
                p.copy_(blob["params"][name])
            for name, buf in (state.grad_buffer or {}).items():
                buf.copy_(blob["grad_buffer"][name])
        state.opt_state.load_state_dict(blob["opt_state"])
        device = next(iter(state.params.values())).device
        state.model_state = _to_device(blob["model_state"], device)
        state.buffer_index = blob["buffer_index"]
        state.step = int(blob["step"])
        if generator is not None and blob.get("generator") is not None:
            generator.set_state(blob["generator"])
        logger.info("restored checkpoint at step %d", step)
        return state, step

    def wait(self) -> None:
        """Block until the last save is durable; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def restore_serving_state(
    directory: str | Path,
    *,
    weight_dtype: str | None = None,
    memory=None,
    recorder=None,
):
    """Load the newest checkpoint for the inference engine.

    Returns ``(params, model_state, step)``: ``params`` is the saved state
    dict on the CPU (the engine places it), ``model_state`` is ``{}`` (BERT
    keeps no mutable state). Raises ``FileNotFoundError`` when the directory
    holds no checkpoint: serving must never silently answer from random
    init. ``weight_dtype`` casts the floating params at the restore
    boundary (``"bfloat16"``/``"float32"``; ``"int8"`` raises until the
    int8 slice); the bytes the cast frees land in the memory registry's
    released ledger (component ``weight_quantization``).
    """
    from distributed_tensorflow_tpu_torch.models.quant import (
        cast_params,
        normalize_quant_dtype,
    )
    from distributed_tensorflow_tpu_torch.obs.memory import default_registry, tree_nbytes

    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    blob = torch.load(
        _step_path(Path(directory), step), map_location="cpu", weights_only=True
    )
    params = blob["params"]
    registry = memory if memory is not None else default_registry()
    wd = normalize_quant_dtype(weight_dtype, "weight_dtype")
    reclaimed = 0
    if wd is not None:
        before = tree_nbytes(params)
        params = cast_params(params, wd)
        reclaimed = max(before - tree_nbytes(params), 0)
        if reclaimed:
            registry.register("weight_quantization", reclaimed)
            registry.release("weight_quantization")
            logger.info(
                "cast restored params to %s: %.1f MiB reclaimed",
                wd, reclaimed / 2**20,
            )
    if recorder is not None:
        recorder.record(
            "ckpt_restore", step=step, weight_dtype=wd,
            quant_reclaimed_bytes=reclaimed,
        )
    logger.info("restored checkpoint at step %d from %s", step, directory)
    return params, {}, step
