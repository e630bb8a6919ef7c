"""Serving checkpoints (``torch.save`` files)."""

from distributed_tensorflow_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    latest_step,
    restore_serving_state,
    save,
)
