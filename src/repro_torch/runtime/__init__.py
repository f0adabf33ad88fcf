from .fault_tolerance import (  # noqa: F401
    ElasticPlan,
    HeartbeatMonitor,
    StragglerMitigator,
    WorkerState,
    plan_elastic_remesh,
)
