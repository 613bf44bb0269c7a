"""Observability: trajectory logging and export, support polygon and
centre of pressure (a copy of
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


def support_polygon(feet_pos, contact_flags):
    """(k,2) xy hull vertices of stance feet (visualizer support polygon,
    reference qm_visualization.cpp:288-317)."""
    pts = np.asarray(feet_pos)[np.asarray(contact_flags) > 0.5][:, :2]
    if len(pts) < 3:
        return pts
    c = pts.mean(0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    return pts[np.argsort(ang)]


def center_of_pressure(feet_pos, forces):
    """(2,) CoP from per-foot positions (4,3) and forces (4,3)
    (reference qm_visualization.cpp CoP marker)."""
    f = np.asarray(forces)
    p = np.asarray(feet_pos)
    fz = np.maximum(f[:, 2], 0.0)
    total = fz.sum()
    if total < 1e-6:
        return p[:, :2].mean(0)
    return (p[:, :2] * fz[:, None]).sum(0) / total
