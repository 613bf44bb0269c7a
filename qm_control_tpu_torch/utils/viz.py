"""Observability: trajectory logging and export (a copy of
qm_control_tpu/utils/viz.py: host-side numpy).

Replaces the reference's QmVisualizer RViz markers
(qm_interface/src/visualization/qm_visualization.cpp:33-345) with
structured per-cycle records, exportable to .npz / JSON.
"""
import json
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class TrajectoryLog:
    """Append-only log of named time series (host side)."""
    series: Dict[str, List] = field(default_factory=dict)

    def append(self, t: float, **values):
        self.series.setdefault("t", []).append(float(t))
        for k, v in values.items():
            self.series.setdefault(k, []).append(np.asarray(v))

    def as_arrays(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.series.items()}

    def __len__(self):
        return len(self.series.get("t", []))


def export_trajectory(log: TrajectoryLog, path: str):
    """Write the log to .npz (arrays) or .json (lists)."""
    arrays = log.as_arrays()
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump({k: v.tolist() for k, v in arrays.items()}, f)
    else:
        np.savez_compressed(path, **arrays)
