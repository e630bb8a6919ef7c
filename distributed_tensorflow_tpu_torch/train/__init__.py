"""Training engine of the port: the train step and the training loop.

Port of the JAX package's ``train`` package for synchronous and K-stale
data parallelism. Fault injection and resilient (supervised) training come
with a later slice.
"""

from distributed_tensorflow_tpu_torch.train.state import (  # noqa: F401
    OptState,
    TrainState,
    Transform,
    create_train_state,
)
from distributed_tensorflow_tpu_torch.train.step import (  # noqa: F401
    aggregate_metric_sums,
    make_eval_step,
    make_rng,
    make_train_step,
)
from distributed_tensorflow_tpu_torch.train.loop import NonFiniteLossError, fit  # noqa: F401
