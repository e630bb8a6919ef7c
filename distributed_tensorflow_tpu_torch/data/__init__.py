"""Input pipelines of the port: synthetic BERT pretraining batches and the
background prefetch stage."""

from distributed_tensorflow_tpu_torch.data.prefetch import prefetch  # noqa: F401
from distributed_tensorflow_tpu_torch.data.text import (  # noqa: F401
    SyntheticMLM,
    SyntheticMLMConfig,
    mlm_device_batches,
)
