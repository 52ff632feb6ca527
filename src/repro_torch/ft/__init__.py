from repro_torch.ft.monitor import (  # noqa: F401
    HeartbeatTracker, PreemptionGuard, StragglerMonitor,
)
from repro_torch.ft.elastic import ElasticPlan, plan_remesh  # noqa: F401
