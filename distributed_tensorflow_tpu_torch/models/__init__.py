"""Models of the port: BERT for masked-LM serving."""

from distributed_tensorflow_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    BertForPreTraining,
    BertModel,
    bert_base,
)
