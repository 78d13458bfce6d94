from .ops import BLOCK_KV, FlashAttention, flash_attention, map_heads

__all__ = ["flash_attention", "FlashAttention", "BLOCK_KV", "map_heads"]
