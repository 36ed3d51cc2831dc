"""Real model serving: pool + executor + engine, and the serving execution
backend that plugs the physical cluster into the unified `repro_torch.api`
stack (`ExecSpec(backend="serving")`); port of `repro/serving`."""
from repro_torch.serving.backend import (ServingRollout,          # noqa: F401
                                         serving_rollout)
from repro_torch.serving.engine import Request, ServingEngine      # noqa: F401
from repro_torch.serving.executor import ModelExecutor, chunkable  # noqa: F401
from repro_torch.serving.pool import LogicalServer, ServerPool     # noqa: F401
from repro_torch.serving.runner import (                           # noqa: F401
    ServingStreamRunner, serve_stream)

__all__ = [
    "Request", "ServingEngine", "ServerPool", "LogicalServer",
    "ModelExecutor", "chunkable", "ServingRollout", "serving_rollout",
    "ServingStreamRunner", "serve_stream",
]
