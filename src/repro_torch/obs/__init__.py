"""repro_torch.obs — dependency-free observability for the protected
serving stack, the port of the JAX package's `repro.obs`.

Three pillars, each with an ambient context-manager install and each free
(a shared no-op singleton) when not installed:

- **metrics** (`use_metrics`): a process-global `MetricsRegistry` of
  labeled counters/gauges/histograms with dict-snapshot, JSONL and
  Prometheus text exporters.
- **trace** (`use_tracer`): `span("engine.step")` context managers that
  wait for a tensor's device work only when given `sync=`, exported as
  Chrome trace-event JSON for Perfetto, and bridged into `torch.profiler`
  with `Tracer(torch_profiler=True)`.
- **ras** (`use_estimator`): `ErrorRateEstimator` folding scan-flag rates
  and `DecodeResult.iterations` into EWMA raw-BER / decoder-stress /
  residual-BER estimates and an `adaptive_interval()` scrub schedule.

    from repro_torch import obs

    with obs.use_metrics() as reg, obs.use_tracer() as tr, \\
         obs.use_estimator() as est:
        engine.run()
    print(reg.to_prometheus())
    tr.to_chrome_trace("trace.json")
    print(est.snapshot())
"""
from . import metrics, ras, trace
from .metrics import (MetricsRegistry, NULL_REGISTRY, instrument_count,
                      use_metrics)
from .ras import ErrorRateEstimator, NULL_ESTIMATOR, use_estimator
from .trace import NULL_TRACER, Tracer, span, use_tracer

current_metrics = metrics.current
current_tracer = trace.current
current_estimator = ras.current

__all__ = [
    "metrics", "trace", "ras",
    "MetricsRegistry", "NULL_REGISTRY", "instrument_count", "use_metrics",
    "current_metrics",
    "Tracer", "NULL_TRACER", "span", "use_tracer", "current_tracer",
    "ErrorRateEstimator", "NULL_ESTIMATOR", "use_estimator",
    "current_estimator",
]
