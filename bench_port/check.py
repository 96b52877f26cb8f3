"""The comparison that decides ``correct``: what the timed path served,
judged by the plain reference of the configuration's model (its model
file, ``reference/<model>.py``) on the same frames and weights.

Each sampled row's served positions are looked up in the reference's f32
heatmap of that row (``reference.common.served_gaps``): a row's gap is
the widest by which a served position lies below the reference row's
best, in units of the row's standard deviation. Two numbers are compared
(inf for an empty sample or a position outside its row):

- ``coord_gap_mean``, the mean of the rows' gaps over the sample, parts
  the bf16 program from its fp8 control, whose rows each lie a little
  off;
- ``coord_gap_max``, the widest, catches a fault in a few rows (a row
  answered with a wrong position reads about 1 or more), which the mean
  averages away; it swings too much from seed to seed to part the
  program from the control (PERF.md).

``missing`` counts the sampled requests that were never answered. Each
has its limit in the configuration's file (``limits``); a missing
request's limit is 0.

The control (``control_gaps``) puts the reference in the program's place,
computed in fp8 (``reference.common.fp8``), the step below the bf16
that the configurations state.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from bench_port.reference.common import argmax_coords, fp8, served_gaps

BLOCK = 32  # rows a reference call, so that its activations fit


def _heat(model: ModuleType, cfg: Mapping, weights, frames: np.ndarray,
          device):
    """The reference heatmap of (n, 1, L) frames, in blocks of rows."""
    for a in range(0, frames.shape[0], BLOCK):
        x = torch.from_numpy(np.ascontiguousarray(frames[a:a + BLOCK]))
        yield a, model.heatmap(weights, x.to(device), cfg)


def gaps(cfg: Mapping, model: ModuleType,
         weights: Mapping[str, torch.Tensor],
         samples: Sequence[Tuple[np.ndarray, np.ndarray]],
         device: torch.device) -> np.ndarray:
    """Every sampled row's gap (``served_gaps``), in sample order, by the
    reference of ``model``, the configuration's model file."""
    up = model.upsample_factor(cfg)
    out = []
    for frames, coords in samples:
        for a, heat in _heat(model, cfg, weights, frames, device):
            got = torch.from_numpy(np.asarray(coords[a:a + BLOCK]))
            out.append(served_gaps(heat, got, up).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(cfg: Mapping, model: ModuleType,
                 weights: Mapping[str, torch.Tensor], frames: np.ndarray,
                 device: torch.device, quant=fp8) -> np.ndarray:
    """Every row's gap of the reference computed through ``quant`` (fp8
    by default) serving in the program's place."""
    up, slots = model.upsample_factor(cfg), cfg["decode"]["max_echoes"]
    out = []
    for a, heat in _heat(model, cfg, weights, frames, device):
        x = torch.from_numpy(np.ascontiguousarray(frames[a:a + BLOCK]))
        low = model.heatmap(weights, x.to(device), cfg, quant)
        served = argmax_coords(low, up, slots)
        out.append(served_gaps(heat, served, up).cpu().numpy())
    return np.concatenate(out)


def checks(cfg: Mapping, row_gaps: np.ndarray, missing: int
           ) -> Dict[str, Dict[str, float]]:
    """Each number compared, beside its limit."""
    empty = not row_gaps.size
    out = {}
    for key, stat in (("coord_gap_mean", np.mean), ("coord_gap_max", np.max)):
        out[key] = {"value": float("inf") if empty else float(stat(row_gaps)),
                    "limit": float(cfg["limits"][key])}
    out["missing"] = {"value": int(missing), "limit": 0}
    return out


def passed(result: Mapping[str, Mapping]) -> bool:
    """Every number at or under its limit (an empty sample reads inf)."""
    return all(v["value"] <= v["limit"] for v in result.values())
