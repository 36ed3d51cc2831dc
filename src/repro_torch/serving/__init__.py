"""Real model serving: pool + executor + engine (port of `repro/serving`;
the stream-native serving backend and runner wait for the API facade,
ROADMAP Queue 1 items 7 and 14)."""
from repro_torch.serving.engine import Request, ServingEngine      # noqa: F401
from repro_torch.serving.executor import ModelExecutor, chunkable  # noqa: F401
from repro_torch.serving.pool import LogicalServer, ServerPool     # noqa: F401

__all__ = ["Request", "ServingEngine", "ServerPool", "LogicalServer",
           "ModelExecutor", "chunkable"]
