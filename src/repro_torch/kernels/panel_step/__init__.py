from .ops import panel_apply, panel_coeff, panel_step

__all__ = ["panel_step", "panel_coeff", "panel_apply"]
