"""Observability for the port: serving and feed metrics, SLOs, health,
tracing, profiling, the flight recorder, fleet health (step timelines,
straggler detection, host beacons), device-memory accounting and the
opt-in lock-order and race sanitizers the concurrency soaks run under."""

from distributed_tensorflow_tpu_torch.obs.export import (  # noqa: F401
    PROM_CONTENT_TYPE,
    prometheus_text,
)
from distributed_tensorflow_tpu_torch.obs.flightrec import (  # noqa: F401
    NULL_RECORDER,
    FlightRecorder,
)
from distributed_tensorflow_tpu_torch.obs.fleet import (  # noqa: F401
    HostBeacon,
    StepTimeline,
    StragglerDetector,
    detect_fleet_stragglers,
    fleet_summary,
    read_beacons,
)
from distributed_tensorflow_tpu_torch.obs.health import (  # noqa: F401
    HealthTracker,
    http_status,
)
from distributed_tensorflow_tpu_torch.obs.memory import (  # noqa: F401
    MemoryRegistry,
    default_registry,
    reset_default_registry,
    tree_nbytes,
)
from distributed_tensorflow_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    FeedMetrics,
    Gauge,
    Histogram,
    JsonlWriter,
    LabelledCounter,
    LabelledHistogram,
    ServeMetrics,
    TensorBoardWriter,
    make_metric_hook,
)
from distributed_tensorflow_tpu_torch.obs.profile import (  # noqa: F401
    profile_window,
    trace_steps,
)
from distributed_tensorflow_tpu_torch.obs.sanitizer import (  # noqa: F401
    LockOrderSanitizer,
    RaceSanitizer,
    sanitize_locks,
    sanitize_races,
)
from distributed_tensorflow_tpu_torch.obs.slo import (  # noqa: F401
    SloSpec,
    SloTracker,
)
from distributed_tensorflow_tpu_torch.obs.timeseries import (  # noqa: F401
    DEFAULT_WINDOWS_S,
    WindowedCounter,
    WindowedHistogram,
    WindowedHistogramFamily,
    bounds_with,
)
from distributed_tensorflow_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    Span,
    Tracer,
)
