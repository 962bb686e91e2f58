"""Run logging: a JSONL metrics file always, wandb when it imports.

Counterpart of ``jumbo_mae_tpu_tpu/utils/logging.py``, copied: the same
record shape, so nothing in the train loop depends on which backend is
live, and :class:`StepTimer` for the throughput and MFU figures.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    def __init__(
        self,
        output_dir: str | Path | None,
        *,
        name: str = "run",
        config: dict | None = None,
        enabled: bool = True,
        use_wandb: bool = True,
        wandb_project: str = "",
        wandb_entity: str = "",
        wandb_tags: tuple[str, ...] = (),
        wandb_id: str = "",
    ):
        self.enabled = enabled
        self._file = None
        self._wandb = None
        if not enabled:
            return
        if output_dir is not None:
            path = Path(output_dir)
            path.mkdir(parents=True, exist_ok=True)
            self._file = open(path / f"{name}-metrics.jsonl", "a", buffering=1)
            if config:
                (path / f"{name}-config.json").write_text(
                    json.dumps(config, indent=2, default=str)
                )
        if use_wandb:
            kwargs: dict = {"name": name, "config": config or {}}
            if wandb_project:
                kwargs["project"] = wandb_project
            if wandb_entity:
                kwargs["entity"] = wandb_entity
            if wandb_tags:
                kwargs["tags"] = list(wandb_tags)
            if wandb_id:
                # stable id → wandb resumes the run after a restart
                kwargs["id"] = wandb_id
                kwargs["resume"] = "allow"
            try:
                import wandb

                self._wandb = wandb.init(**kwargs)
            except ImportError:
                self._wandb = None  # JSONL-only environments are expected
            except Exception as e:  # noqa: BLE001
                print(f"[logging] wandb.init failed ({e}); JSONL only")
                self._wandb = None

    def log(self, metrics: dict, step: int | None = None):
        if not self.enabled:
            return
        record = {"_time": time.time(), **({"step": step} if step is not None else {}), **metrics}
        if self._file is not None:
            self._file.write(json.dumps(record, default=float) + "\n")
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()
            self._wandb = None


class StepTimer:
    """Wall-clock step timing with warmup exclusion; feeds MFU reporting."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._seen = 0
        self._t0: float | None = None
        self._timed = 0

    def tick(self):
        """Call once per completed (blocked-on) step."""
        self._seen += 1
        if self._seen == self.warmup_steps:
            self._t0 = time.perf_counter()
            self._timed = 0
        elif self._seen > self.warmup_steps:
            self._timed += 1

    @property
    def steps_per_sec(self) -> float | None:
        if self._t0 is None or self._timed == 0:
            return None
        return self._timed / (time.perf_counter() - self._t0)
