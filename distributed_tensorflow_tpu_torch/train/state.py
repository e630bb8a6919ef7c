"""Train state: everything the train step reads and writes.

Port of ``train/state.py``. The JAX package threads one immutable pytree
through a jitted step; here the state is a mutable dataclass that the step
updates in place (the parameters are the model's own tensors, the
optimizer keeps its slots beside them), which is what buffer donation buys
the JAX step.

:class:`Transform` stands where an optax ``GradientTransformation`` stands
in the JAX package: ``init(params)`` builds the optimizer over the
parameters, and its learning-rate schedule is read at the update count
*before* the update, as optax reads it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch


class ScheduleLR(torch.optim.lr_scheduler.LRScheduler):
    """Sets every group's learning rate to ``schedule(count)``, where
    ``count`` is the number of optimizer steps taken so far. Step it after
    ``optimizer.step()``: update k (0-based) then runs at ``schedule(k)``,
    optax's pre-increment read."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self):
        lr = float(self.schedule(self.last_epoch))
        return [lr for _ in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state_dict: dict) -> None:
        self.last_epoch = int(state_dict["last_epoch"])
        lr = float(self.schedule(self.last_epoch))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self._last_lr = [lr for _ in self.optimizer.param_groups]


@dataclasses.dataclass
class OptState:
    """The optimizer and its schedule; ``apply()`` is one update from the
    gradients already in each parameter's ``.grad``."""

    optimizer: torch.optim.Optimizer
    scheduler: ScheduleLR

    def apply(self) -> None:
        self.optimizer.step()
        self.scheduler.step()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])

    def slots(self) -> dict:
        """The optimizer's per-parameter tensors (Adam's moments), for
        memory accounting."""
        return {str(i): s for i, s in enumerate(self.optimizer.state.values())}


@dataclasses.dataclass(frozen=True)
class Transform:
    """How to build the optimizer over a parameter dict, and the learning
    rate ``schedule(count)`` it runs."""

    make: Callable[[dict[str, torch.Tensor]], torch.optim.Optimizer]
    schedule: Callable[[int], float]

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        optimizer = self.make(params)
        return OptState(optimizer, ScheduleLR(optimizer, self.schedule))


@dataclasses.dataclass
class TrainState:
    """The whole training state.

    Attributes:
      step: global step (a host integer).
      params: name -> parameter tensor; the model's own parameters, so an
        update to them is an update to the model.
      opt_state: the optimizer and its schedule (:class:`OptState`).
      model_state: mutable model collections (BERT has none).
      grad_buffer: ``None`` for sync DP; for the async-stale flavour, name ->
        ``[K, *shape]`` ring of past aggregated gradients, emulating
        parameter-server staleness deterministically.
      buffer_index: next slot to overwrite in ``grad_buffer``.
    """

    step: int
    params: dict[str, torch.Tensor]
    opt_state: OptState
    model_state: Any = dataclasses.field(default_factory=dict)
    grad_buffer: dict[str, torch.Tensor] | None = None
    buffer_index: int | None = None


def create_train_state(
    params: dict[str, torch.Tensor],
    tx: Transform,
    model_state: Any = None,
    staleness: int = 0,
) -> TrainState:
    """Build the initial :class:`TrainState` (step 0).

    ``staleness=K > 0`` allocates the K-deep zero gradient ring of the
    async-stale flavour: the first K applied updates are zero, as from a
    parameter server whose workers have not delivered yet.
    """
    grad_buffer = None
    buffer_index = None
    if staleness > 0:
        grad_buffer = {
            name: torch.zeros((staleness,) + tuple(p.shape), dtype=p.dtype, device=p.device)
            for name, p in params.items()
        }
        buffer_index = 0
    return TrainState(
        step=0,
        params=dict(params),
        opt_state=tx.init(params),
        model_state=model_state if model_state is not None else {},
        grad_buffer=grad_buffer,
        buffer_index=buffer_index,
    )
