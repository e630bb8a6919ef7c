"""Hand-written kernels for Hopper, each beside its plain PyTorch version."""

from distributed_tensorflow_tpu_torch.ops.flash_attention import (  # noqa: F401
    LAUNCHES,
    flash_attention,
    flash_attention_block,
    flash_attention_reference,
    reset_launch_counts,
)
