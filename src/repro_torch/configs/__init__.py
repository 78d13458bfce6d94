"""The paper's benchmark grid, the port's own copy of
``repro.configs.paper_rid``."""
from .paper_rid import (PAPER_GRID, PAPER_PROCS, PAPER_TABLE5_ERRORS,
                        SMALL_GRID, RIDCase)

__all__ = ["RIDCase", "PAPER_GRID", "SMALL_GRID", "PAPER_PROCS",
           "PAPER_TABLE5_ERRORS"]
