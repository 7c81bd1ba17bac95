from .driver import FaultTolerantTrainer, InjectedFault
from .straggler import StragglerMonitor

__all__ = ["FaultTolerantTrainer", "InjectedFault", "StragglerMonitor"]
