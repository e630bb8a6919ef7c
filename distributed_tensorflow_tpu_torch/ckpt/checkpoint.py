"""Checkpoints over ``torch.save`` files (port of ``ckpt/checkpoint.py``).

One file per step, ``<dir>/step_<step>.pt``, holding at least ``{"step",
"params"}`` with ``params`` a model ``state_dict`` on the CPU. Writes go to
a temporary name and are renamed into place, so a reader never sees half a
file. :func:`save` writes params only; the training :class:`Checkpointer`
adds the optimizer state, the stale gradient ring and the generator state
to the same file, so :func:`restore_serving_state` serves a training
checkpoint unchanged.

Under several processes (:mod:`..parallel.mesh`) the ranks hold the same
replicated state, so rank 0 alone writes and prunes, every rank reads, and
the ranks agree on the newest step by rank 0's word: the coordination the
JAX package's orbax checkpointer does across its processes. The directory
is one that every rank sees. Under sharded parameters (tensor, expert
or pipeline parallelism, ``Checkpointer(param_specs=...)``) the file holds
the GLOBAL tree: every rank gathers the parameters, the optimizer's
per-parameter slots and the stale ring over every axis that shards them
before rank 0 writes, and a restore keeps the slices of the mesh it runs
on. So a checkpoint written at one layout restores at any other, and
:func:`restore_serving_state` serves it unchanged.

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
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.parallel.mesh import barrier, process_count, process_index

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


def _slot_names(state) -> list[str]:
    """The parameter name of each index of the optimizer's state dict (its
    parameters numbered through the param groups in order)."""
    name_of = {id(p): name for name, p in state.params.items()}
    return [name_of[id(p)] for group in state.opt_state.optimizer.param_groups
            for p in group["params"]]


def _map_sharded(state, blob: dict, specs: dict, fn) -> dict:
    """``blob`` (params, opt_state, grad_buffer as :meth:`Checkpointer.save`
    lays them out) with ``fn(tree, specs)`` applied to the parameters, to
    the optimizer slots shaped like them and to the stale ring (its leaves
    sharded one dim further in)."""
    out = dict(blob)
    out["params"] = fn(blob["params"], specs)
    names = _slot_names(state)
    opt = blob["opt_state"]
    slots = {}
    for idx, entry in opt["optimizer"]["state"].items():
        name = names[idx]
        shape = blob["params"][name].shape
        flat = {k: v for k, v in entry.items()
                if isinstance(v, torch.Tensor) and v.dim() and v.shape == shape}
        done = fn(flat, {k: specs.get(name) for k in flat})
        slots[idx] = {**entry, **done}
    out["opt_state"] = {**opt, "optimizer": {**opt["optimizer"], "state": slots}}
    if blob.get("grad_buffer"):
        ring_specs = {k: None if specs.get(k) is None
                      else tuple((axis, dim + 1) for axis, dim in specs[k])
                      for k in blob["grad_buffer"]}
        out["grad_buffer"] = fn(blob["grad_buffer"], ring_specs)
    return out


class Checkpointer:
    """Periodic train-state checkpoints with restore-latest.

    ``save`` copies the state to the CPU on the caller's thread (the step
    updates the parameters in place right after) and writes the file on a
    background thread; ``wait`` blocks until the last write is durable.
    The newest ``max_to_keep`` files are kept.

    Under several processes every rank calls ``save``, ``latest_step`` and
    ``restore_latest`` at the same points (they meet in collectives): rank 0
    snapshots, writes and prunes, and the ranks meet at a barrier after
    its snapshot; ``latest_step`` is rank 0's, after its last write is
    durable, so a rank that restores reads a whole file. Usage::

        ckpt = Checkpointer(dir)
        state, start = ckpt.restore_latest(state, generator=g)  # (state, 0) on a fresh dir
        fit(state, step, data, rng=g, checkpointer=ckpt, ckpt_every=500, ...)
        ckpt.close()
    """

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3, fault_injector=None,
                 param_specs: dict | None = None):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self._injector = fault_injector
        # The sharding of the parameters (bert_param_specs), or None: the
        # state is saved as it is.
        self._specs = (param_specs if param_specs and any(v is not None for v in
                                                           param_specs.values()) else None)
        self._thread: threading.Thread | None = None
        # The writer's failure, handed to the caller's wait() under a lock
        # (not only through the join: the writer thread sets it).
        self._error_lock = threading.Lock()
        self._error: BaseException | None = None

    def save(self, step: int, state, *, generator: torch.Generator | None = None) -> None:
        """Save ``state`` (a :class:`~..train.state.TrainState`) as ``step``,
        with ``generator``'s state when one is given. Only rank 0 writes;
        every rank returns after rank 0 has taken its snapshot.

        ``fault_injector`` (:mod:`..train.faultinject`) may raise a
        scheduled ``ckpt_write_error`` here, first thing: every rank holds
        the same plan, so every rank raises at the same step and none waits
        at the barrier alone."""
        if self._injector is not None:
            self._injector.check_ckpt_save(step)
        blob = None
        if self._specs is not None:
            # Every rank meets in the gathers over the sharding axes, one leaf
            # at a time: rank 0 moves each global leaf to the host at once
            # and the others drop theirs, so no card ever holds the whole
            # global tree.
            from distributed_tensorflow_tpu_torch.interop import gather_params
            from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

            mesh = active_mesh()

            def gather(tree, specs):
                out = {}
                for k, v in tree.items():
                    g = gather_params({k: v}, {k: specs.get(k)}, mesh)[k]
                    out[k] = g.to("cpu", copy=True) if process_index() == 0 else None
                return out

            blob = _map_sharded(state, {
                "params": state.params, "opt_state": state.opt_state.state_dict(),
                "grad_buffer": state.grad_buffer}, self._specs, gather)
        if process_index() != 0:
            barrier()
            return
        if blob is None:
            blob = {"params": state.params, "opt_state": state.opt_state.state_dict(),
                    "grad_buffer": state.grad_buffer}
        blob = {
            "step": int(step),
            "params": _to_cpu(blob["params"]),
            "opt_state": _to_cpu(blob["opt_state"]),
            "model_state": _to_cpu(state.model_state),
            "grad_buffer": _to_cpu(blob["grad_buffer"]),
            "buffer_index": state.buffer_index,
            "generator": None if generator is None else generator.get_state(),
        }
        self.wait()
        self._thread = threading.Thread(
            target=self._write_and_prune, args=(int(step), blob),
            name="ckpt-writer", daemon=True)
        self._thread.start()
        barrier()

    def _write_and_prune(self, step: int, blob: dict) -> None:
        try:
            _write(self.directory, step, blob)
            steps = sorted(
                int(m.group(1)) for p in self.directory.iterdir()
                if (m := _STEP_FILE.match(p.name)))
            for old in steps[:-self.max_to_keep]:
                _step_path(self.directory, old).unlink(missing_ok=True)
        except Exception as e:  # re-raised by wait() on the caller's thread
            with self._error_lock:
                self._error = e

    def latest_step(self) -> int | None:
        """Newest saved step, counting a save still being written: rank 0's
        answer on every rank, given once its last write is durable."""
        self.wait()
        step = latest_step(self.directory) if process_index() == 0 else None
        if process_count() > 1:
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        return step

    def restore_latest(self, state, *, generator: torch.Generator | None = None):
        """Load the newest checkpoint into ``state`` in place (parameters,
        optimizer state, stale ring, step), its ``model_state`` (BatchNorm
        running statistics) onto the parameters' device, and, when both
        exist, the saved generator state into ``generator``. Every rank
        reads the step that rank 0 names onto its own device. Returns
        ``(state, step)``; ``(state, 0)`` untouched when there is no
        checkpoint."""
        step = self.latest_step()
        if step is None:
            return state, 0
        blob = torch.load(_step_path(self.directory, step), map_location="cpu",
                          weights_only=True)
        if self._specs is not None:
            from distributed_tensorflow_tpu_torch.interop import shard_params
            from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

            mesh = active_mesh()
            blob = _map_sharded(state, blob, self._specs,
                                lambda tree, specs: shard_params(tree, specs, mesh))
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
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
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
    num_heads: int | None = None,
    memory=None,
    recorder=None,
):
    """Load the newest checkpoint for an inference engine.

    Returns ``(params, model_state, step)``: ``params`` is the saved state
    dict on the CPU (the engine places it), ``model_state`` what the
    training run kept beside it (``{"batch_stats": ...}`` for the image
    models, ``{}`` for BERT and the causal LM, and for files written by
    :func:`save`). Raises ``FileNotFoundError`` when the directory holds no
    checkpoint: serving must never silently answer from random init.

    ``weight_dtype`` converts the params at the restore boundary:
    ``"int8"`` packs every eligible kernel (:func:`~..models.quant.
    quantize_params`; ``num_heads`` is the model's head count, which the
    attention projections' scales need), ``"bfloat16"``/``"float32"`` cast.
    Then every replaced leaf is freed (:func:`~..models.quant.
    free_replaced_leaves`), and the bytes land in the memory registry's
    released ledger (component ``weight_quantization``). The optimizer
    state and gradient ring of a training checkpoint are never kept.
    """
    from distributed_tensorflow_tpu_torch.models.quant import (
        cast_params,
        free_replaced_leaves,
        normalize_quant_dtype,
        quantize_params,
    )
    from distributed_tensorflow_tpu_torch.obs.memory import default_registry

    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    # Memory-mapped: only the leaves read (the params) come off the disk,
    # never a training checkpoint's optimizer state.
    blob = torch.load(
        _step_path(Path(directory), step), map_location="cpu", weights_only=True, mmap=True
    )
    params = blob["params"]
    model_state = blob.get("model_state") or {}
    registry = memory if memory is not None else default_registry()
    wd = normalize_quant_dtype(weight_dtype, "weight_dtype")
    reclaimed = 0
    if wd is not None:
        new_params = (quantize_params(params, num_heads) if wd == "int8"
                      else cast_params(params, wd))
        # Quantize-then-free: only REPLACED leaves go (embeddings, biases
        # and LayerNorms are shared by identity and survive).
        reclaimed = free_replaced_leaves(params, new_params)
        params = new_params
        if reclaimed:
            registry.register("weight_quantization", reclaimed)
            registry.release("weight_quantization")
            logger.info(
                "converted restored params to %s: %.1f MiB reclaimed",
                wd, reclaimed / 2**20,
            )
    if recorder is not None:
        recorder.record(
            "ckpt_restore", step=step, weight_dtype=wd,
            quant_reclaimed_bytes=reclaimed,
        )
    logger.info("restored checkpoint at step %d from %s", step, directory)
    return params, model_state, step
