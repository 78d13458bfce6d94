from .ops import tsolve

__all__ = ["tsolve"]
