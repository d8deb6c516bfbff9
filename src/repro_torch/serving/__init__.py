"""The serving layer of the port (counterpart of ``src/repro/serving/``):
the batched decode engine and the Redynis session router."""

from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kvcache import LaneTable, state_bytes
from repro_torch.serving.router import RouteResult, SessionRouter

__all__ = ["Request", "ServeEngine", "LaneTable", "state_bytes", "RouteResult", "SessionRouter"]
