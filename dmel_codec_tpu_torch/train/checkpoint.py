"""Step-indexed checkpoints with latest-checkpoint auto-resume (port of
`dmel_codec_tpu/train/checkpoint.py`, same interface).

The format is this package's own: a train state's `state_dict()` maps its
top-level fields (`step`, `params`, `opt_state`, ...) to plain objects of
tensors, and every field is written with `torch.save` to its own file,

    <directory>/step_<N>/<field>.pt     one per field
    <directory>/step_<N>/meta.json      {"step": N, "metrics": {...} | null}

so that serving can read `params` without the optimizer's moments. A
checkpoint is written under a temporary name and renamed when complete; a
directory without `meta.json` (a half-written one) is never listed.

Retention: without `best_metric` the manager keeps the `max_to_keep` newest
steps (the auto-resume behaviour); with it, the `max_to_keep` best by that
metric, a save without metrics ranked worst (it is still written, and still
resumable through `latest_step` until evicted). Saves are synchronous:
`wait` returns at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
from typing import Any, Optional, Sequence

import torch

_STEP_DIR = re.compile(r"step_(\d+)")
_META = "meta.json"


def _check_like(got: Any, want: Any, path: str) -> None:
    """`got` (restored) has the keys and tensor shapes of `want`."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            missing = sorted(set(want) - set(got))[:5] if isinstance(got, dict) else "all"
            extra = sorted(set(got) - set(want))[:5] if isinstance(got, dict) else []
            raise ValueError(f"checkpoint field {path}: keys differ (missing {missing}, unexpected {extra})")
        for key in want:
            _check_like(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape:
            raise ValueError(
                f"checkpoint field {path}: expected a tensor of shape {tuple(want.shape)}, "
                f"got {tuple(got.shape) if isinstance(got, torch.Tensor) else type(got).__name__}"
            )


class CheckpointManager:
    """Step-indexed checkpoints under `directory`, keep-k, auto-resume."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 2,
        best_metric: Optional[str] = None,
        best_mode: str = "min",
    ):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        os.makedirs(self.directory, exist_ok=True)

    # ---- listing -----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> list:
        """Complete checkpoints, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.fullmatch(name)
            if m and os.path.isfile(os.path.join(self.directory, name, _META)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _meta(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), _META)) as f:
            return json.load(f)

    # ---- saving ------------------------------------------------------------
    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        """Write `state` (anything with `state_dict()`, or a dict of fields)
        as step `step`. `metrics` (plain floats) ranks this checkpoint when
        the manager was built with `best_metric`."""
        fields = state.state_dict() if hasattr(state, "state_dict") else dict(state)
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, value in fields.items():
            torch.save(value, os.path.join(tmp, f"{name}.pt"))
        kept = None
        if metrics is not None:
            kept = {k: float(v) for k, v in metrics.items()}
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump({"step": int(step), "metrics": kept}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._evict()

    def _rank(self, step: int) -> float:
        """Smaller is better; a save without the metric ranks worst."""
        metrics = self._meta(step)["metrics"] or {}
        value = metrics.get(self.best_metric)
        if value is None or math.isnan(value):
            return math.inf
        return value if self.best_mode == "min" else -value

    def _evict(self) -> None:
        steps = self.all_steps()
        if self.best_metric is not None:
            # best first; among equals the newer
            steps = sorted(steps, key=lambda s: (self._rank(s), -s), reverse=True)
        for step in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def wait(self) -> None:
        """Saves are synchronous; kept for the interface."""

    def close(self) -> None:
        """Nothing to release; kept for the interface."""

    # ---- restoring ---------------------------------------------------------
    def _load_field(self, step: int, name: str) -> Any:
        path = os.path.join(self._step_dir(step), f"{name}.pt")
        if not os.path.isfile(path):
            raise KeyError(f"checkpoint step {step} under {self.directory} has no field {name!r}")
        # weights_only: the files hold tensors, numbers, strings, lists and dicts
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_latest(self, abstract_state: Any) -> Optional[Any]:
        """Restore the newest checkpoint INTO `abstract_state` (a freshly
        initialised train state of the same structure; its tensors are
        overwritten in place) and return it, or None when no checkpoint
        exists."""
        step = self.latest_step()
        if step is None:
            return None
        want = abstract_state.state_dict()
        fields = {name: self._load_field(step, name) for name in want}
        abstract_state.load_state_dict(fields)
        return abstract_state

    def restore_latest_fields(
        self, abstract_state: Any, fields: Sequence[str]
    ) -> Optional[dict]:
        """Partial restore of selected top-level train-state fields (e.g.
        ('params', 'step') for inference: the optimizer state's structure
        can differ between the training and serving configurations). With an
        `abstract_state` (a state, or a dict of fields) the restored fields
        must have its keys and tensor shapes; None skips that check."""
        step = self.latest_step()
        if step is None:
            return None
        out = {name: self._load_field(step, name) for name in fields}
        if abstract_state is not None:
            want = (
                abstract_state.state_dict() if hasattr(abstract_state, "state_dict") else abstract_state
            )
            for name in fields:
                if name in want:
                    _check_like(out[name], want[name], name)
        return out
