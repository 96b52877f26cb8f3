"""Metrics logging (the port's own copy of ``stofnet_tpu/utils/logging.py``):
every run writes a local JSONL stream and a summary JSON; W&B mirrors the
same events when the package is installed and ``logging`` names a group
(off by default).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


_ADJ = ("swift", "quiet", "bright", "calm", "bold", "amber", "coral", "misty",
        "sunny", "vivid", "lunar", "polar", "rapid", "gentle", "golden")
_NOUN = ("falcon", "river", "echo", "summit", "breeze", "comet", "harbor",
         "aurora", "signal", "meadow", "ridge", "sonar", "pulse", "drift")


def make_run_name(seed: Optional[int] = None,
                  run_dir: Optional[str | Path] = None) -> str:
    """A name drawn from ``seed``. With ``run_dir``, the first name of
    ``seed``, ``seed + 1``, ... that no run there has logged under: two
    runs started within one second from one seed (a sweep's rows) would
    otherwise share a name, and the later one's summary would replace the
    earlier one's."""
    import random

    seed = seed if seed is not None else time.time_ns()
    while True:
        r = random.Random(seed)
        name = f"{r.choice(_ADJ)}-{r.choice(_NOUN)}-{r.randrange(1000, 9999)}"
        if run_dir is None or not (Path(run_dir) / f"{name}.jsonl").exists():
            return name
        seed += 1


class MetricsLogger:
    """A run's JSONL stream, summary, figures and W&B mirror.
    ``write=False`` keeps the summary in memory and writes nothing: a
    data-parallel rank other than 0, whose rank 0 writes the run's
    files."""

    def __init__(self, run_dir: str | Path, run_name: str,
                 config: Optional[Dict[str, Any]] = None,
                 wandb_group: Optional[str] = None, write: bool = True):
        self.run_dir = Path(run_dir)
        self.run_name = run_name
        self.path = self.run_dir / f"{run_name}.jsonl"
        self.write = write
        self.summary: Dict[str, Any] = {}
        self._wandb = None
        if not write:
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        if wandb_group:
            try:
                import wandb

                self._wandb = wandb.init(project="stofnet_tpu",
                                         group=str(wandb_group),
                                         name=run_name, config=config or {})
            except Exception:
                self._wandb = None
        if config is not None:
            self.log({"event": "config", **{k: _jsonable(v)
                                            for k, v in config.items()}})

    def log(self, record: Dict[str, Any]) -> None:
        if not self.write:
            return
        record = {k: _jsonable(v) for k, v in record.items()}
        record.setdefault("ts", time.time())
        self._fh.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            try:
                self._wandb.log({k: v for k, v in record.items()
                                 if isinstance(v, (int, float))})
            except Exception:
                pass

    def log_figure(self, key: str, fig, path: Optional[Path] = None) -> None:
        """Save a matplotlib figure as PNG and mirror it to W&B."""
        if not self.write:
            return
        if path is not None:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(path, dpi=110)
        if self._wandb is not None:
            try:
                import wandb

                from stofnet_tpu_torch.utils.plotting import fig_to_array

                self._wandb.log({key: wandb.Image(fig_to_array(fig))})
            except Exception:
                pass

    def log_artifact(self, path: str | Path, name: str,
                     kind: str = "model") -> None:
        """Mirror a file/dir to W&B as an artifact (the final checkpoint).
        Local runs already have the file on disk; this is W&B-only."""
        if self._wandb is None:
            return
        try:
            import wandb

            art = wandb.Artifact(name, type=kind)
            p = Path(path)
            if p.is_dir():
                art.add_dir(str(p))
            else:
                art.add_file(str(p))
            self._wandb.log_artifact(art)
        except Exception:
            pass

    def set_summary(self, **kwargs: Any) -> None:
        self.summary.update({k: _jsonable(v) for k, v in kwargs.items()})

    def finish(self) -> None:
        if not self.write:
            return
        with open(self.run_dir / f"{self.run_name}_summary.json", "w") as f:
            json.dump(self.summary, f, indent=2)
        if self._wandb is not None:
            try:
                for k, v in self.summary.items():
                    self._wandb.summary[k] = v
                self._wandb.finish()
            except Exception:
                pass
        self._fh.close()


def _jsonable(v: Any):
    import numpy as np

    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, Path):
        return str(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v
