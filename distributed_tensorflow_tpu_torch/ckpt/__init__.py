"""Checkpoints (``torch.save`` files): training state and serving params."""

from distributed_tensorflow_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    Checkpointer,
    latest_step,
    restore_serving_state,
    save,
)
