"""``CheckpointManager`` (periodic save, restore-latest-valid, the SIGTERM
preemption hook) and ``ElasticPlan`` (the per-replica batch schedule after
a scale change), re-exported for the training substrate from
``repro_torch.resilience.fault_tolerance``. The step watchdog that flags
stragglers is ``train_loop.StepWatchdog``."""
from repro_torch.resilience.fault_tolerance import CheckpointManager, ElasticPlan  # noqa: F401
