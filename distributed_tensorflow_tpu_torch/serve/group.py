"""Serving over a model-parallel group of ranks: one leader, the others
followers (the port's counterpart of the JAX engines' serving mesh).

The JAX package serves a mesh from ONE process over several devices: each
engine cell is a ``shard_map`` executable, and one call runs it on every
device. Here a device is a process, so a served layout (``"model"``,
``"expert"``, ``"pipeline"`` and ``"data"`` axes of
:func:`..parallel.mesh.build_mesh`) is a group of processes that each run
the same cell on their shard:

- **Leader and followers.** Every rank of the serving job builds the same
  engine with the same arguments; the constructor warms the same grid in
  the same order on every rank, so the collectives inside the warm-up line
  up. Rank 0, the leader, owns the :class:`~.server.Client`, the batchers
  and the HTTP front end. The other ranks call the engine's ``follow()``
  and stay in :meth:`ServingGroup.follow` until the leader stops them.
- **Cells.** Each engine entry point that launches device work is a cell
  (BERT and image: ``dispatch``; the causal LM: ``prefill``,
  ``prefill_chunks``, ``decode``, ``verify``, ``insert_prefix``, the
  prefix-page and slot-page exports and imports). On the leader,
  :meth:`ServingGroup.issue` broadcasts the cell's name and its host
  operands, then runs the cell; a follower receives them and runs the same
  cell on its shard. ``fetch``/``fetch_step`` stay on the leader and run no
  collective.
- **Control channel.** The messages are pickled CPU tensors broadcast over
  a gloo group made for them (``dist.new_group(backend="gloo")``), apart
  from the model's own groups, which stay on the job's backend: the same
  code serves over NCCL across cards and over gloo on one card or the CPU.
  Nothing on the channel is a CUDA tensor. A gloo group's timeout is each
  rank's own: a follower waits for the next cell as long as the server
  idles, the leader's broadcast at most the job's collective timeout
  (:func:`..parallel.mesh.collective_timeout`).
- **Order.** Broadcast and launch are one critical section under the
  group's lock, so the leader's dispatching threads (the dynamic batcher's
  ``max_in_flight`` overlap, the continuous batcher's loop) issue the
  model's collectives in the order the followers receive the cells.
- **Shutdown and failure.** :meth:`ServingGroup.stop` (from
  ``Client.close()`` on the leader, through the engine's ``close``)
  broadcasts a stop, and ``follow()`` returns 0. A follower that dies or
  hangs makes the leader's next cell raise (a closed socket at once; a
  broadcast no peer takes, or a hung peer, within the job's collective
  timeout): the batch fails (HTTP 500), the group is marked broken, and
  every later cell raises, so the leader never serves on alone. A
  follower whose cell raises exits with the error: it never skips a cell,
  which would leave the others waiting. Nothing here falls back to one
  process.

During construction (:meth:`ServingGroup.start` not yet called) every rank
runs the engine's constructor itself, so ``issue`` runs the cell directly.
"""

from __future__ import annotations

import datetime
import logging
import threading
import time

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

STOP = "__stop__"
# How long a follower may wait for the leader's next cell: a server may sit
# idle, and a leader that dies closes the channel's sockets, which ends the
# wait at once.
IDLE_TIMEOUT = datetime.timedelta(days=7)


def _to_wire(x):
    """A cell operand as the control channel carries it: CPU tensors (any
    dtype, bf16 included), numbers and containers of them."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_wire(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_wire(v) for v in x)
    return x


class ServingGroup:
    """The leader/follower protocol of a serving job over ``mesh``, the job's
    active mesh (every rank of the process group, see the module
    docstring)."""

    def __init__(self, mesh):
        from distributed_tensorflow_tpu_torch.parallel.mesh import (
            collective_timeout,
            process_count,
            process_index,
        )

        if not dist.is_initialized() or mesh.size != process_count():
            raise RuntimeError(
                f"a serving group over the mesh {dict(mesh.shape)} needs a process group of "
                f"{mesh.size} ranks (initialize_runtime first); got {process_count()}")
        self.mesh = mesh
        self.rank = process_index()
        self.size = mesh.size
        # The leader's broadcast must not wait as long as an idle follower
        # may: over NCCL, a follower SIGKILLed mid-decode left it waiting
        # for good.
        self._ctrl = dist.new_group(
            backend="gloo", timeout=collective_timeout() if self.rank == 0 else IDLE_TIMEOUT)
        self._lock = threading.Lock()
        self._live = False
        self._broken: str | None = None
        self._stopped = False
        # The leader's broadcast seconds and cells issued: the control
        # channel's part of a request's collectives share (PERF.md), beside
        # the model's collectives over the job's backend.
        self.control_seconds = 0.0
        self.cells_issued = 0

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def start(self) -> None:
        """End of construction: from here on the leader's cells go through
        the channel and the followers' through :meth:`follow`."""
        self._live = True

    def _send(self, msg) -> None:
        t0 = time.perf_counter()
        dist.broadcast_object_list([msg], src=0, group=self._ctrl)
        self.control_seconds += time.perf_counter() - t0

    def _recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self._ctrl)
        return box[0]

    def issue(self, op: str, operands: tuple, fn):
        """Run cell ``op`` as ``fn(*operands)``: on the leader of a started
        group, broadcast ``(op, operands)`` first, both under the lock.
        Raises when the group is broken or stopped."""
        if not self._live:
            return fn(*operands)
        if not self.is_leader:
            raise RuntimeError(f"cell {op!r} issued on follower rank {self.rank}: "
                               "followers run cells from follow()")
        with self._lock:
            if self._broken is not None:
                raise RuntimeError(f"serving group broken ({self._broken}): the leader "
                                   "does not serve without its followers")
            if self._stopped:
                raise RuntimeError("serving group stopped")
            try:
                self._send((op, _to_wire(operands)))
                self.cells_issued += 1
                return fn(*operands)
            except Exception as e:
                self._broken = f"{op}: {type(e).__name__}: {e}"
                logger.error("serving group broken at cell %s: %s", op, e)
                raise

    def follow(self, run) -> int:
        """A follower's loop: receive each cell and run it as ``run(op,
        operands)``, until the leader's stop; returns 0. A cell that raises
        propagates (the process should exit: the group cannot go on)."""
        if self.is_leader:
            raise RuntimeError("the leader serves; only followers follow")
        self._live = True
        n = 0
        while True:
            op, operands = self._recv()
            if op == STOP:
                logger.info("serving group rank %d: stop after %d cells", self.rank, n)
                return 0
            run(op, operands)
            n += 1

    def stop(self) -> None:
        """Leader: broadcast the stop once (a broken group's followers are
        gone or stuck: nothing is sent). Idempotent."""
        if not self.is_leader or not self._live:
            return
        with self._lock:
            if self._stopped or self._broken is not None:
                self._stopped = True
                return
            self._stopped = True
            self._send((STOP, ()))

    def status(self) -> dict:
        return {"ranks": self.size, "broken": self._broken, "stopped": self._stopped,
                "cells_issued": self.cells_issued, "control_seconds": self.control_seconds}
