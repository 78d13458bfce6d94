from .ops import BLOCK_KV, FlashAttention, flash_attention

__all__ = ["flash_attention", "FlashAttention", "BLOCK_KV"]
