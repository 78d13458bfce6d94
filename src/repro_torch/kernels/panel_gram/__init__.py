from .ops import panel_gram

__all__ = ["panel_gram"]
