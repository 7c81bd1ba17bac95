from .ops import flash_attention

__all__ = ["flash_attention"]
