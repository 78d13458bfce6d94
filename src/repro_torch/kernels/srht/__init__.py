from .ops import fwht, fwht_factors, srht

__all__ = ["fwht", "fwht_factors", "srht"]
