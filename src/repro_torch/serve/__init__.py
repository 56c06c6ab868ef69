from .engine import DecodeEngine, ServeConfig
from .query_serve import QueryServer
from .scheduler import QueryScheduler, DEFAULT_BATCH_WINDOW

__all__ = ["DecodeEngine", "ServeConfig", "QueryServer", "QueryScheduler",
           "DEFAULT_BATCH_WINDOW"]
