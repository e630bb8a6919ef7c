"""Hand-written kernels for Hopper, each beside its plain PyTorch version:
flash attention (:mod:`.flash_attention`), the 1x1-conv dgrad
(:mod:`.pointwise_conv`) and the fused conv+BN backward
(:mod:`.fused_conv_bn`); :mod:`.build` compiles their libraries."""

from distributed_tensorflow_tpu_torch.ops.flash_attention import (  # noqa: F401
    LAUNCHES,
    flash_attention,
    flash_attention_block,
    flash_attention_reference,
    reset_launch_counts,
)
