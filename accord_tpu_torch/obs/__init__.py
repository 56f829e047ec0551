"""Observability: the unified metrics registry and flight recorder.

`obs.metrics` holds the `MetricsRegistry` (named counters / gauges /
timers / log2-bucket histograms) that backs every bench counter in the
resolver, the exec plane, and the maelstrom runner. `obs.trace` is the
ring-buffer `FlightRecorder` threaded through the protocol and device
pipeline; `obs.export` turns its events into Chrome `trace_event` JSON
loadable in Perfetto (`python -m accord_tpu_torch.obs.export --summarize`).
"""
from accord_tpu_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, RegCounter, RegTimer, Timer,
)
from accord_tpu_torch.obs.trace import REC, FlightRecorder, recorder

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RegCounter",
    "RegTimer", "Timer", "FlightRecorder", "REC", "recorder",
]
