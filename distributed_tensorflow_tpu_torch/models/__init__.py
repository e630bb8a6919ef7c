"""Models of the port: BERT for masked-LM serving and pretraining, the
decoder-only causal LM, and the image classifiers (LeNet-5, ResNet-20,
ResNet-50, Inception-v3)."""

from distributed_tensorflow_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    BertForPreTraining,
    BertModel,
    bert_base,
)
from distributed_tensorflow_tpu_torch.models.causal_lm import (  # noqa: F401
    CausalLM,
    CausalLMConfig,
    causal_lm_base,
)
from distributed_tensorflow_tpu_torch.models.inception import InceptionV3  # noqa: F401
from distributed_tensorflow_tpu_torch.models.lenet import LeNet5  # noqa: F401
from distributed_tensorflow_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet20,
    ResNet50,
)
