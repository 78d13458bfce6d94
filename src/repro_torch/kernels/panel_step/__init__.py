from .ops import panel_step

__all__ = ["panel_step"]
