"""Model registry (counterpart of ``flaxdiff_tpu/trainer/registry.py``):
run records, per-metric best tracking and checkpoint lookup over a local
``registry.json``, in the JAX package's file format, so either package reads
a registry the other wrote.

The JAX package layers wandb artifacts on top (``push_artifact``,
``pull_artifact``); wandb is not installed on the port's machines, and
both are no-ops here, as they are in the JAX package without wandb.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class ModelRegistry:
    """JSON-file registry of training runs and their best checkpoints.

    Layout of registry.json:
      {"runs": {run_name: {config, checkpoint_dir, step, metrics,
                           updated}},
       "best": {metric_name: {"run": ..., "value": ...,
                              "higher_is_better": ...}}}
    """

    def __init__(self, path: str):
        self.path = path
        self._data: Dict[str, Any] = {"runs": {}, "best": {}}
        if os.path.exists(path):
            with open(path) as fh:
                self._data = json.load(fh)
        self._data.setdefault("runs", {})
        self._data.setdefault("best", {})

    def _save(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".",
                    exist_ok=True)
        # pid-unique tmp: concurrent writers (two runs finishing at once)
        # cannot clobber each other's tmp file; last replace wins whole
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self._data, fh, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    # -- write ---------------------------------------------------------------
    def register_run(self, name: str, checkpoint_dir: str, step: int,
                     metrics: Dict[str, float],
                     metric_directions: Optional[Dict[str, bool]] = None,
                     config: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, bool]:
        """Record/update a run; returns {metric: became_best},
        direction-aware via `metric_directions` ({name: higher_is_better},
        default lower)."""
        run = self._data["runs"].setdefault(name, {})
        run.update({
            "checkpoint_dir": checkpoint_dir,
            "step": int(step),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "updated": time.time(),
        })
        if config is not None:
            run["config"] = config

        # persist directions, then RECOMPUTE best from all runs' current
        # metrics — a run re-registering with a worse value must not keep
        # holding "best" with a stale value whose checkpoint has rotated
        # away (max_to_keep).
        dirs = self._data.setdefault("directions", {})
        for metric, hib in (metric_directions or {}).items():
            dirs[metric] = bool(hib)
        self._recompute_best()
        became_best = {m: self._data["best"].get(m, {}).get("run") == name
                       for m in metrics}
        self._save()
        return became_best

    def _recompute_best(self):
        dirs = self._data.get("directions", {})
        best: Dict[str, Any] = {}
        for name, run in self._data["runs"].items():
            for metric, value in run.get("metrics", {}).items():
                hib = bool(dirs.get(metric, False))
                cur = best.get(metric)
                if (cur is None or (value > cur["value"] if hib
                                    else value < cur["value"])):
                    best[metric] = {
                        "run": name, "value": float(value),
                        "higher_is_better": hib,
                        "checkpoint_dir": run["checkpoint_dir"],
                        "step": int(run["step"]),
                    }
        self._data["best"] = best

    def push_artifact(self, name: str, checkpoint_dir: str) -> bool:
        """Upload the checkpoint as a wandb artifact: wandb is not
        installed, so nothing is uploaded and this returns False (the JAX
        package's answer without wandb)."""
        return False

    # -- read ----------------------------------------------------------------
    def runs(self) -> Dict[str, Any]:
        return dict(self._data["runs"])

    def top_k(self, metric: str, k: int = 5):
        """Ranked top-k runs for `metric` with their run metadata,
        direction-aware via the persisted metric directions."""
        hib = bool(self._data.get("directions", {}).get(metric, False))
        ranked = []
        for name, run in self._data["runs"].items():
            if metric in run.get("metrics", {}):
                ranked.append({
                    "run": name,
                    "value": float(run["metrics"][metric]),
                    "step": int(run.get("step", 0)),
                    "checkpoint_dir": run.get("checkpoint_dir"),
                    "config": run.get("config"),
                    "higher_is_better": hib,
                })
        ranked.sort(key=lambda r: r["value"], reverse=hib)
        return ranked[:k]

    def best_run(self, metric: str) -> Optional[Dict[str, Any]]:
        return self._data["best"].get(metric)

    def best_checkpoint(self, metric: str) -> Optional[str]:
        best = self.best_run(metric)
        return best["checkpoint_dir"] if best else None



def pull_artifact(name: str, target_dir: str, alias: str = "latest") -> Optional[str]:
    """Download a wandb model artifact: wandb is not installed, so this
    returns None (the JAX package's answer without wandb)."""
    return None
