"""The port's static-analysis suite over its own sources.

Checkers:

* :mod:`.locklint`  — static concurrency rules (LL001–LL003)
* :mod:`.racelint`  — cross-thread shared-state rules (RC001–RC003)
* :mod:`.shardcheck`— mesh-axis and serving-layout validation (SC001–SC002)

plus the runtime lock-order + data-race sanitizers in
:mod:`distributed_tensorflow_tpu_torch.obs.sanitizer`. Run everything via
``scripts/torch_analyze.py``; the baseline of intentional findings is
``analysis/baseline.json`` beside this file.

Port of the JAX package's ``analysis/`` (its ``jaxlint`` checks JAX
idioms and has no counterpart here).
"""

from .findings import (
    Baseline,
    BaselineResult,
    Finding,
    ScopeIndex,
    SourceFile,
    apply_baseline,
    dotted_name,
    iter_sources,
    load_baseline,
)

__all__ = [
    "Baseline",
    "BaselineResult",
    "Finding",
    "ScopeIndex",
    "SourceFile",
    "apply_baseline",
    "dotted_name",
    "iter_sources",
    "load_baseline",
]
