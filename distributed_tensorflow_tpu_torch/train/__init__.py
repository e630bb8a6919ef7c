"""Training engine of the port: the train step and the training loop.

Port of the JAX package's ``train`` package for synchronous and K-stale
data parallelism, with deterministic fault injection (:mod:`.faultinject`)
and resilient, preemption-safe training (:mod:`.resilience`).
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
from distributed_tensorflow_tpu_torch.train.faultinject import (  # noqa: F401
    FaultEvent,
    FaultInjector,
    FaultPlan,
    InjectedFault,
)
from distributed_tensorflow_tpu_torch.train.resilience import (  # noqa: F401
    ResilienceConfig,
    ResilienceReport,
    run_resilient,
)
