"""(workload features, config, reward) episode store (DESIGN.md §13).

"Learning from the Past" (arXiv 2504.12074) warm-starts tuning from the
history of earlier episodes; this module is that substrate for the serve
loop: every shadow/canary/live/promotion event appends one JSONL row of
``{cycle, role, clock_s, workload, config, reward, p99_ms, breached}``.
Rows are flushed per append (a killed service loses at most the row being
written); on crash-resume the controller truncates rows newer than the
restored checkpoint cycle so the on-disk history matches the restored
promotion log exactly.

``best_config_for`` is the first warm-start consumer: nearest-workload
lookup by (kind, rate) over promoted/canary rows — deliberately simple,
the contextual-policy version is a ROADMAP item.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Optional

import numpy as np


def _jsonable(o):
    """Recursively convert numpy scalars/arrays so rows survive json.dumps."""
    if isinstance(o, dict):
        return {k: _jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    if isinstance(o, np.ndarray):
        return [_jsonable(v) for v in o.tolist()]
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.bool_,)):
        return bool(o)
    return o


def workload_features(workload, t: float = 0.0) -> dict:
    """The row's workload descriptor: law kind + instantaneous rate/size at
    the row's clock — enough for the nearest-workload warm-start query."""
    return {"kind": type(workload).__name__,
            "rate": float(workload.rate(t)),
            "mean_size": float(workload.mean_size(t))}


class EpisodeStore:
    """Append-only episode history, JSONL on disk (or in-memory when
    ``path`` is None — tests and throwaway runs). ``write=False`` reads the
    rows on disk and keeps every later one in memory only (the ranks of a
    process group other than the one that writes)."""

    def __init__(self, path: Optional[str | Path] = None, *,
                 write: bool = True):
        self.path = Path(path) if path is not None else None
        self.write = write
        self._rows: list[dict] = []
        if self.path is not None and self.path.exists():
            self._rows = [json.loads(line) for line in
                          self.path.read_text().splitlines() if line.strip()]
        elif self.path is not None and write:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def __len__(self) -> int:
        return len(self._rows)

    def append(self, *, cycle: int, role: str, workload: dict, config: dict,
               reward: float, p99_ms: float, clock_s: float,
               breached: bool = False) -> dict:
        row = _jsonable({"cycle": int(cycle), "role": role,
                         "clock_s": float(clock_s), "workload": workload,
                         "config": config, "reward": float(reward),
                         "p99_ms": float(p99_ms), "breached": bool(breached)})
        self._rows.append(row)
        if self.path is not None and self.write:
            with self.path.open("a") as f:
                f.write(json.dumps(row) + "\n")
                f.flush()
        return row

    def rows(self, *, role: Optional[str] = None) -> list[dict]:
        if role is None:
            return list(self._rows)
        return [r for r in self._rows if r["role"] == role]

    def truncate_to_cycle(self, cycle: int) -> int:
        """Drop rows newer than ``cycle`` (crash-resume: rows appended after
        the restored checkpoint never happened as far as the resumed
        controller is concerned). Returns how many rows were dropped."""
        keep = [r for r in self._rows if r["cycle"] <= cycle]
        dropped = len(self._rows) - len(keep)
        if dropped:
            self._rows = keep
            if self.path is not None and self.write:
                self.path.write_text(
                    "".join(json.dumps(r) + "\n" for r in keep))
        return dropped

    # ------------------------------------------------------- warm-start query
    def best_config_for(self, features: dict, *,
                        roles: tuple = ("promote", "canary")) -> Optional[dict]:
        """Highest-reward stored config among the rows whose workload is
        nearest to ``features`` (same kind, closest log-rate). Rows that
        breached SLO are never candidates — a breached canary/live row can
        carry a deceptively high reward (one fast window before the queue
        explodes), and warm-starting from it would re-canary a config the
        gate already rejected."""
        cand = [r for r in self._rows
                if r["role"] in roles and not r.get("breached")]
        same_kind = [r for r in cand
                     if r["workload"].get("kind") == features.get("kind")]
        if same_kind:
            cand = same_kind
        if not cand:
            return None
        rate = max(float(features.get("rate", 1.0)), 1e-9)

        def dist(r):
            return abs(math.log(max(float(r["workload"].get("rate", 1.0)),
                                    1e-9) / rate))

        nearest = min(dist(r) for r in cand)
        near = [r for r in cand if dist(r) <= nearest + 1e-12]
        return dict(max(near, key=lambda r: r["reward"])["config"])
