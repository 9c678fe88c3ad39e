from .pylogger import RankedLogger

__all__ = ["RankedLogger"]
