from .engine import Request, ServeEngine
from .scheduler import (PREFILL_FRACTION, AdmissionControl, AdmissionError,
                        ContinuousScheduler, HostDispatch, ServeReport,
                        ServeSLO, StepCostModel, TraceRequest,
                        TrafficEstimator, simulate_serve)

__all__ = [
    "AdmissionControl", "AdmissionError", "ContinuousScheduler",
    "HostDispatch", "PREFILL_FRACTION", "Request", "ServeEngine",
    "ServeReport", "ServeSLO", "StepCostModel", "TraceRequest",
    "TrafficEstimator", "simulate_serve",
]
