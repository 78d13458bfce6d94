from .ops import ACCUM_BLOCK, accum_dtype_for, sketch_accum

__all__ = ["sketch_accum", "ACCUM_BLOCK", "accum_dtype_for"]
