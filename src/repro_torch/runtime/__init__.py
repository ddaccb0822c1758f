"""Runtime: fault tolerance, preemption, stragglers, elastic scaling
(port of ``repro.runtime``)."""
from repro_torch.runtime.fault_tolerance import (PreemptionHandler,
                                                 SimulatedFailure,
                                                 StragglerMonitor,
                                                 TrainSupervisor,
                                                 elastic_shrink_plan)

__all__ = ["PreemptionHandler", "SimulatedFailure", "StragglerMonitor",
           "TrainSupervisor", "elastic_shrink_plan"]
