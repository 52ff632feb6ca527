from repro_torch.ft.monitor import (  # noqa: F401
    HeartbeatTracker, PreemptionGuard, StragglerMonitor,
)
