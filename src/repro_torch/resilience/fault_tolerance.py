"""Step-counted checkpointing and elastic data schedules, the training
flavor of ``resilience`` (the reference keeps them in
``src/repro/train/fault_tolerance.py``; ``repro_torch.train.fault_tolerance``
re-exports them from here).

* ``CheckpointManager`` — periodic save, restore-latest-valid, the
  preemption-signal hook. A partial newest checkpoint is impossible by
  construction (atomic rename); a corrupt one is deleted and the previous
  window entry restored.
* ``ElasticPlan`` — maps a checkpoint to another device count: arrays are
  stored unsharded and ``restore`` places them on the device asked for,
  so elasticity is recomputing the per-replica batch schedule.
"""
from __future__ import annotations

import os
import signal
from dataclasses import dataclass, field
from typing import Any

from repro_torch.resilience import checkpoint as ckpt_lib


@dataclass
class CheckpointManager:
    ckpt_dir: str
    every_steps: int = 100
    keep: int = 3
    _preempted: bool = field(default=False, repr=False)

    def install_preemption_handler(self) -> None:
        """SIGTERM (the cloud preemption signal) ⇒ checkpoint at next step."""
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def should_save(self, step: int) -> bool:
        return self._preempted or (step > 0 and step % self.every_steps == 0)

    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        path = ckpt_lib.save(self.ckpt_dir, step, tree, extra=extra, keep=self.keep)
        self._preempted = False
        return path

    def restore_latest(self, like: Any, device=None):
        """Restore the newest valid checkpoint as ``(step, tree, meta)``;
        walk back on corruption; ``(None, None, {})`` when there is none."""
        step = ckpt_lib.latest_step(self.ckpt_dir)
        while step is not None:
            try:
                tree, meta = ckpt_lib.restore(self.ckpt_dir, step, like, device)
                return step, tree, meta
            except Exception:  # partial/corrupt → try the previous one
                os.unlink(os.path.join(self.ckpt_dir, f"step_{step:08d}.npz"))
                step = ckpt_lib.latest_step(self.ckpt_dir)
        return None, None, {}


@dataclass(frozen=True)
class ElasticPlan:
    """Re-derive the per-replica data schedule after a scale change."""
    global_batch: int
    n_pods: int

    def batch_per_pod(self) -> int:
        if self.global_batch % self.n_pods:
            raise ValueError(
                "elastic resize requires the global batch to divide the new pod "
                f"count (got {self.global_batch} over {self.n_pods})"
            )
        return self.global_batch // self.n_pods

    def data_shard_for(self, pod_id: int, step: int) -> tuple[int, int]:
        """Deterministic (start, size) cursor into the step's global batch —
        exactly-once data consumption after an elastic restore."""
        per = self.batch_per_pod()
        return pod_id * per, per
