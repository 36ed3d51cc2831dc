"""Streaming traffic (port of `repro/traffic`): open-loop arrival
processes, windowed unbounded-horizon simulation on the batched rollout
engine, and streaming QoS telemetry. See `arrivals`, `stream`, `metrics`,
`policies`, `sweep`."""
from repro_torch.traffic.arrivals import (DiurnalArrivals, FlashCrowdArrivals,
                                          MMPPArrivals, PoissonArrivals,
                                          ReplayArrivals, generate_trace,
                                          make_process, scale_rate)
from repro_torch.traffic.metrics import LatencyHistogram, StreamAggregator
from repro_torch.traffic.stream import (CurriculumTaskSource,
                                        ProcessTaskSource, StreamConfig,
                                        StreamResult, StreamRunner,
                                        TraceTaskSource, WindowResult,
                                        run_stream)

__all__ = [
    "PoissonArrivals", "MMPPArrivals", "DiurnalArrivals",
    "FlashCrowdArrivals", "ReplayArrivals", "make_process", "generate_trace",
    "scale_rate",
    "LatencyHistogram", "StreamAggregator",
    "StreamConfig", "StreamResult", "StreamRunner", "WindowResult",
    "CurriculumTaskSource", "ProcessTaskSource", "TraceTaskSource",
    "run_stream",
]
