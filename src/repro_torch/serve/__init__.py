from .query_serve import QueryServer
from .scheduler import QueryScheduler, DEFAULT_BATCH_WINDOW

__all__ = ["QueryServer", "QueryScheduler", "DEFAULT_BATCH_WINDOW"]
