from .ops import rglru_scan, rglru_scan_bwd

__all__ = ["rglru_scan", "rglru_scan_bwd"]
