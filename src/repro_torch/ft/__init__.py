from repro_torch.ft.failures import (
    FailureInjector,
    StragglerMonitor,
    TrainSupervisor,
)

__all__ = ["FailureInjector", "StragglerMonitor", "TrainSupervisor"]
