from .ops import queue_matmul

__all__ = ["queue_matmul"]
