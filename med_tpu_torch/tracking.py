"""File-based run tracking (the port's copy of ``med_tpu.tracking``: the
same directory layout and file formats, so either package reads the other's
runs).

The reference logs params/metrics/artifacts to an MLflow server at
http://127.0.0.1:8080 and later re-reads best-model JSON dicts from it
(modeling_utils.py:2377-2692). Here a run is a directory:

    runs/<experiment>/<run_id>/
        params.json          — config dump
        metrics.jsonl        — {"key":…, "value":…, "step":…} per line
        artifacts/<name>.json — arbitrary JSON dicts (best-model dumps)
        checkpoints/…        — model checkpoints

so result aggregation and the ensemble/sequential stages are file-driven
with no tracking server.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class RunTracker:
    def __init__(self, root: str = "runs", experiment: str = "default",
                 run_id: Optional[str] = None):
        self.experiment = experiment
        self.run_id = run_id or uuid.uuid4().hex[:16]
        self.dir = os.path.join(root, experiment, self.run_id)
        os.makedirs(os.path.join(self.dir, "artifacts"), exist_ok=True)
        os.makedirs(os.path.join(self.dir, "checkpoints"), exist_ok=True)
        self._metrics = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    # ------------------------------------------------------------------
    def log_params(self, params: Dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "params.json"), "w") as f:
            json.dump(_jsonable(params), f, indent=1)

    def log_metric(self, key: str, value, step: int = 0) -> None:
        self._metrics.write(
            json.dumps({"key": key, "value": _jsonable(value), "step": step,
                        "time": time.time()})
            + "\n"
        )
        self._metrics.flush()

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_dict(self, d: Dict[str, Any], name: str) -> None:
        with open(os.path.join(self.dir, "artifacts", name), "w") as f:
            json.dump(_jsonable(d), f)

    def checkpoint_path(self, name: str) -> str:
        return os.path.join(self.dir, "checkpoints", name)

    # ------------------------------------------------------------------
    @staticmethod
    def load_artifact(root: str, experiment: str, run_id: str, name: str) -> dict:
        with open(os.path.join(root, experiment, run_id, "artifacts", name)) as f:
            return json.load(f)

    @staticmethod
    def find_run(root: str, run_id: str) -> str:
        """Locate a run directory by id across experiments."""
        for exp in sorted(os.listdir(root)):
            p = os.path.join(root, exp, run_id)
            if os.path.isdir(p):
                return p
        raise FileNotFoundError(f"run {run_id} not found under {root}")
