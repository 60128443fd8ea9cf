"""Training substrate: AdamW with a float32 or an 8-bit state
(``optimizer``), gradient compression (``compression``), the train step
with microbatch accumulation and the straggler watchdog (``train_loop``),
and the checkpoint shims (``checkpoint``, ``fault_tolerance``)."""
from repro_torch.train.fault_tolerance import CheckpointManager, ElasticPlan
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_opt_state
from repro_torch.train.train_loop import StepWatchdog, TrainConfig, make_train_step

__all__ = ["AdamWConfig", "CheckpointManager", "ElasticPlan", "StepWatchdog",
           "TrainConfig", "apply_updates", "init_opt_state", "make_train_step"]
