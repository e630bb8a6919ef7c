"""Input pipelines of the port: synthetic BERT pretraining batches, the
image-classification feed, and the background prefetch stage."""

from distributed_tensorflow_tpu_torch.data.loader import device_batches  # noqa: F401
from distributed_tensorflow_tpu_torch.data.prefetch import prefetch  # noqa: F401
from distributed_tensorflow_tpu_torch.data.readers import load_dataset  # noqa: F401
from distributed_tensorflow_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification,
    synthetic_image_classification,
)
from distributed_tensorflow_tpu_torch.data.text import (  # noqa: F401
    SyntheticMLM,
    SyntheticMLMConfig,
    mlm_device_batches,
)
