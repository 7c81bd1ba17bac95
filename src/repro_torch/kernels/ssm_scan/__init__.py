from .ops import ssm_scan

__all__ = ["ssm_scan"]
