from .ops import latent_attention

__all__ = ["latent_attention"]
