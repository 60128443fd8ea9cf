"""Fault tolerance for the streaming pipeline: killed processes
(checkpoint/resume — ``checkpoint``), corrupt or flaky input
(validation/quarantine — ``validate``), and a way to prove both
deterministically (fault injection — ``chaos``). Graceful degradation in
the hot paths lives with the code it guards (``FA2Config.nan_guard``,
``serve/tiles.TileEngine``). The step-counted ``CheckpointManager`` and
``ElasticPlan`` come from ``fault_tolerance``.

Checkpoints are the reference package's format: either package resumes
from what the other wrote.
"""
from repro_torch.resilience.chaos import (
    ChaosConfig,
    ChaosEdgeStore,
    KillSwitch,
    SimulatedPreemption,
    poison_weights,
)
from repro_torch.resilience.checkpoint import (
    CheckpointMismatchError,
    Preempted,
    StreamCheckpointer,
    config_fingerprint,
    latest_step,
    load_arrays,
    restore,
    restore_latest_valid,
    save,
)
from repro_torch.resilience.fault_tolerance import CheckpointManager, ElasticPlan
from repro_torch.resilience.validate import (
    ValidationAccounting,
    ValidationError,
    ValidationPolicy,
    validated_read,
)

__all__ = [
    "CheckpointManager",
    "CheckpointMismatchError",
    "ChaosConfig",
    "ChaosEdgeStore",
    "ElasticPlan",
    "KillSwitch",
    "Preempted",
    "SimulatedPreemption",
    "StreamCheckpointer",
    "ValidationAccounting",
    "ValidationError",
    "ValidationPolicy",
    "config_fingerprint",
    "latest_step",
    "load_arrays",
    "poison_weights",
    "restore",
    "restore_latest_valid",
    "save",
    "validated_read",
]
