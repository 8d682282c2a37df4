from .engine import EngineStats, Request, ServingEngine
from .lifecycle import (TERMINAL_STATUSES, EngineStallError, RequestStatus)

__all__ = ["EngineStats", "Request", "ServingEngine", "TERMINAL_STATUSES",
           "EngineStallError", "RequestStatus"]
