from .ops import ssm_scan, ssm_scan_bwd, ssm_scan_states

__all__ = ["ssm_scan", "ssm_scan_bwd", "ssm_scan_states"]
