"""Input pipelines of the port: BERT pretraining batches (synthetic or from
a text corpus), causal-LM batches, the image-classification feeds (numpy, or the host C++
augmenting pipeline), the dataset readers, and the background prefetch
stage."""

from distributed_tensorflow_tpu_torch.data.loader import (  # noqa: F401
    device_batches,
    native_device_batches,
)
from distributed_tensorflow_tpu_torch.data.prefetch import prefetch  # noqa: F401
from distributed_tensorflow_tpu_torch.data.readers import load_dataset  # noqa: F401
from distributed_tensorflow_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification,
    synthetic_image_classification,
)
from distributed_tensorflow_tpu_torch.data.text import (  # noqa: F401
    SyntheticLM,
    SyntheticMLM,
    SyntheticMLMConfig,
    TextCorpusConfig,
    TextCorpusMLM,
    mlm_device_batches,
)
