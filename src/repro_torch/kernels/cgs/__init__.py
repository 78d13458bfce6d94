from .ops import panel_deflate, project_out

__all__ = ["project_out", "panel_deflate"]
