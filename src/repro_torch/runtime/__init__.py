from repro_torch.runtime.fault import FaultPolicy, StragglerPolicy, backoff_delay, run_with_retries
from repro_torch.runtime.loop import TrainLoop, TrainLoopConfig

__all__ = [
    "TrainLoop",
    "TrainLoopConfig",
    "FaultPolicy",
    "StragglerPolicy",
    "backoff_delay",
    "run_with_retries",
]
