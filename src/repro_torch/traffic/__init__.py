"""Streaming traffic: open-loop arrival processes and streaming QoS
telemetry. The windowed stream engine (`traffic/stream.py`) is ROADMAP
Queue 1 item 8."""
from repro_torch.traffic.arrivals import (DiurnalArrivals, FlashCrowdArrivals,
                                          MMPPArrivals, PoissonArrivals,
                                          ReplayArrivals, generate_trace,
                                          make_process, scale_rate)

__all__ = [
    "PoissonArrivals", "MMPPArrivals", "DiurnalArrivals",
    "FlashCrowdArrivals", "ReplayArrivals", "make_process", "generate_trace",
    "scale_rate",
]
