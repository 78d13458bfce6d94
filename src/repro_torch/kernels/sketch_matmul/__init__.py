from .ops import sketch_matmul

__all__ = ["sketch_matmul"]
