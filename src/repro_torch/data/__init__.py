from .pipeline import PrefetchLoader, SyntheticLMStream

__all__ = ["PrefetchLoader", "SyntheticLMStream"]
