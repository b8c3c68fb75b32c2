"""Checkpoint-durability gate for evicting live training jobs, over the
port's checkpoint layout.

The port of ``tpu_operator_libs/health/checkpoint_gate.py``:
``latest_committed_step`` and ``CheckpointDurabilityGate`` keep their call
contract (``check()``, ``min_step``, ``max_age_seconds``,
``__call__(node, pods)`` as PodManager's ``eviction_gate``), without that
module's ``k8s.objects`` import. During a rolling upgrade the operator
keeps a node parked until the training job's newest checkpoint is
durable; eviction then costs at most the steps since that commit.

Layout, as ``tpu_operator_libs_torch/examples/training_job.py`` writes it
with ``torch.distributed.checkpoint`` (DCP) instead of Orbax:

- each step is a subdirectory of the checkpoint root named by its number;
- DCP's ``FileSystemWriter`` writes the shards (``*.distcp``), then
  ``.metadata.tmp``, and renames that to ``.metadata`` last;
- so a step is committed iff ``<step>/.metadata`` exists. A directory
  that holds only shards or ``.metadata.tmp`` is still being written.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)

#: the file DCP renames into place last: its presence is the commit
METADATA = ".metadata"


def committed_steps(checkpoint_dir: str) -> "list[int]":
    """The committed step numbers under ``checkpoint_dir``, ascending
    (empty when the directory does not exist)."""
    try:
        names = os.listdir(checkpoint_dir)
    except (FileNotFoundError, NotADirectoryError):
        return []
    return sorted(
        int(name) for name in names
        if name.isdecimal()
        and os.path.isfile(os.path.join(checkpoint_dir, name, METADATA)))


def latest_committed_step(checkpoint_dir: str) -> Optional[int]:
    """Newest committed step number under ``checkpoint_dir``, or None."""
    steps = committed_steps(checkpoint_dir)
    return steps[-1] if steps else None


@dataclass
class CheckpointDurabilityGate:
    """Eviction gate: open once a sufficiently fresh checkpoint is durable.

    - ``min_step``: require at least this step to be committed.
    - ``max_age_seconds``: require the newest commit (its ``.metadata``'s
      mtime) to be within this window; 0 disables the age check.
    """

    checkpoint_dir: str
    min_step: Optional[int] = None
    max_age_seconds: float = 0.0

    def check(self) -> bool:
        step = latest_committed_step(self.checkpoint_dir)
        if step is None:
            logger.info("checkpoint gate: no committed checkpoint in %s",
                        self.checkpoint_dir)
            return False
        if self.min_step is not None and step < self.min_step:
            logger.info("checkpoint gate: latest committed step %d < "
                        "required %d", step, self.min_step)
            return False
        if self.max_age_seconds > 0:
            age = self._age_of_step(step)
            if age is None or age > self.max_age_seconds:
                logger.info("checkpoint gate: step %d age %s exceeds %.0fs",
                            step, age, self.max_age_seconds)
                return False
        logger.info("checkpoint gate open: step %d durable in %s",
                    step, self.checkpoint_dir)
        return True

    def _age_of_step(self, step: int) -> Optional[float]:
        try:
            mtime = os.path.getmtime(
                os.path.join(self.checkpoint_dir, str(step), METADATA))
        except OSError:
            return None
        return time.time() - mtime

    def __call__(self, node, pods) -> bool:  # PodManager eviction_gate
        return self.check()
