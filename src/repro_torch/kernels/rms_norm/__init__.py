from .ops import rms_norm

__all__ = ["rms_norm"]
