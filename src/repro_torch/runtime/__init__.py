from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor, RestartPolicy, StragglerMitigator, run_supervised,
)
from repro_torch.runtime.elastic import ElasticMeshPlan, plan_elastic

__all__ = [
    "HeartbeatMonitor", "RestartPolicy", "StragglerMitigator",
    "run_supervised", "ElasticMeshPlan", "plan_elastic",
]
