"""Perf interpolators for the SLA planner (port of
`dynamo_tpu/planner/interpolation.py`).

Role of the reference's `planner/utils/perf_interpolation.py` (cubic
scipy interpolators over pre-deployment profiling npz): map predicted
load onto the profiled perf surface to get expected TTFT/ITL and
achievable throughput per device (the profile's "chip", one card for the
port).  Re-designed on plain numpy linear interpolation — the profile
grids are dense enough that cubic buys nothing, and scipy stays out of
the serving image.

Profile format (produced by planner/profiler.py, stored as JSON):

    {"prefill": {"isl": [...], "ttft_s": [...], "tok_s_per_chip": [...]},
     "decode":  {"kv_usage": [...], "context": [...],
                 "itl_s": [[...]], "tok_s_per_chip": [[...]]}}

Decode grids are [len(context), len(kv_usage)] — context (row) by
kv-load (column), mirroring the reference's 2D (kv_usage x context)
surface.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np


class PrefillInterpolator:
    """isl → expected TTFT and prefill throughput/chip."""

    def __init__(self, profile: Dict) -> None:
        p = profile["prefill"]
        self.isl = np.asarray(p["isl"], np.float64)
        self.ttft = np.asarray(p["ttft_s"], np.float64)
        self.thpt = np.asarray(p["tok_s_per_chip"], np.float64)
        order = np.argsort(self.isl)
        self.isl, self.ttft, self.thpt = (
            self.isl[order], self.ttft[order], self.thpt[order])

    def interpolate_ttft(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.ttft))

    def interpolate_thpt_per_chip(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.thpt))


class DecodeInterpolator:
    """(kv_usage, context) → expected ITL and decode throughput/chip."""

    def __init__(self, profile: Dict) -> None:
        d = profile["decode"]
        self.kv = np.asarray(d["kv_usage"], np.float64)
        self.ctx = np.asarray(d["context"], np.float64)
        self.itl = np.asarray(d["itl_s"], np.float64)      # [ctx, kv]
        self.thpt = np.asarray(d["tok_s_per_chip"], np.float64)
        if self.itl.shape != (len(self.ctx), len(self.kv)):
            raise ValueError(f"decode grid shape {self.itl.shape} != "
                             f"({len(self.ctx)}, {len(self.kv)})")

    def _ctx_row(self, context: float) -> int:
        return int(np.argmin(np.abs(self.ctx - context)))

    def interpolate_itl(self, kv_usage: float, context: float) -> float:
        row = self._ctx_row(context)
        return float(np.interp(kv_usage, self.kv, self.itl[row]))

    def interpolate_thpt_per_chip(self, kv_usage: float,
                                  context: float) -> float:
        row = self._ctx_row(context)
        return float(np.interp(kv_usage, self.kv, self.thpt[row]))

    def find_best_throughput_per_chip(self, itl: float,
                                      context: float) -> float:
        """Highest-load throughput whose ITL still meets the target —
        scanned from the loaded end because interpolated ITL need not be
        monotonic (reference `find_best_throughput_per_gpu`)."""
        row = self._ctx_row(context)
        for col in range(len(self.kv) - 1, -1, -1):
            if self.itl[row, col] <= itl:
                return float(self.thpt[row, col])
        return float(self.thpt[row, 0])


def load_profile(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def save_profile(profile: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(profile, f)
