"""Serving checkpoints over ``torch.save`` files.

One file per step, ``<dir>/step_<step>.pt``, holding ``{"step", "params"}``
with ``params`` a model ``state_dict`` on the CPU. Writes go to a temporary
name and are renamed into place, so a reader never sees half a file.

Port of the serving half of the JAX package's ``ckpt/checkpoint.py``
(``restore_serving_state``). Importing an orbax checkpoint written by the
JAX package needs JAX to read it and is left to a later slice: convert such
params with :mod:`..interop` and ``save`` them here.
"""

from __future__ import annotations

import logging
import os
import re
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


def save(directory: str | Path, step: int, state_dict: dict) -> Path:
    """Write ``state_dict`` (moved to the CPU) as step ``step``."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    params = {k: v.detach().cpu() for k, v in state_dict.items()}
    path = _step_path(d, int(step))
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save({"step": int(step), "params": params}, tmp)
    os.replace(tmp, path)
    return path


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
