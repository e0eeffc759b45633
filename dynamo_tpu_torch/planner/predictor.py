"""Load predictors (port of `dynamo_tpu/planner/predictor.py`; reference
`planner/utils/load_predictor.py:159`).

The reference ships constant / ARIMA / Prophet; constant, moving-average
and the pure-NumPy AR(p) rung cover the load-planner's needs without the
heavyweight deps (statsmodels and Prophet are not dependencies — ARPredictor
is the ARIMA slot: an autoregression fit by least squares catches the
periodic/diurnal structure a moving average always lags)."""

from __future__ import annotations

from collections import deque
from typing import Deque

import numpy as np


class ConstantPredictor:
    """Next value = last observation."""

    def __init__(self) -> None:
        self._last = 0.0

    def add_data_point(self, value: float) -> None:
        self._last = float(value)

    def predict_next(self) -> float:
        return self._last


class MovingAveragePredictor:
    """Next value = mean of the last `window` observations."""

    def __init__(self, window: int = 5) -> None:
        self._buf: Deque[float] = deque(maxlen=window)

    def add_data_point(self, value: float) -> None:
        self._buf.append(float(value))

    def predict_next(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0


class TrendPredictor:
    """Next value = linear extrapolation over the last `window` points —
    the lightweight stand-in for the reference's ARIMA rung (it catches
    the monotone ramps an autoscaler must lead, without statsmodels)."""

    def __init__(self, window: int = 8) -> None:
        self._buf: Deque[float] = deque(maxlen=window)

    def add_data_point(self, value: float) -> None:
        self._buf.append(float(value))

    def predict_next(self) -> float:
        n = len(self._buf)
        if n == 0:
            return 0.0
        if n == 1:
            return self._buf[0]
        xs = range(n)
        mean_x = (n - 1) / 2.0
        mean_y = sum(self._buf) / n
        cov = sum((x - mean_x) * (y - mean_y)
                  for x, y in zip(xs, self._buf))
        var = sum((x - mean_x) ** 2 for x in xs)
        slope = cov / var if var else 0.0
        return max(0.0, mean_y + slope * (n - mean_x))


class ARPredictor:
    """AR(p) one-step predictor, least-squares fit over a sliding window
    (the pure-NumPy stand-in for the reference's ARIMA rung).

    Next value = c + sum_i(phi_i * y[t-i]), with (c, phi) refit on every
    prediction from the last `window` observations.  On periodic load
    (the diurnal traffic curve an autoscaler must lead) the lags carry
    the phase information a moving average destroys: MA predicts the
    recent mean and is always half a swing late; AR(p) extrapolates the
    oscillation itself.

    Falls back down the rungs while history is short: constant (1 point),
    linear trend (< 2p+2 points) — so the planner can use it from cold
    start without special-casing.
    """

    def __init__(self, order: int = 8, window: int = 128,
                 ridge: float = 1e-6) -> None:
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        if window < 2 * order + 2:
            raise ValueError(
                f"window {window} too small for order {order} "
                f"(need >= {2 * order + 2})")
        self.order = order
        self.ridge = ridge
        self._buf: Deque[float] = deque(maxlen=window)
        self._trend = TrendPredictor(window=min(8, window))

    def add_data_point(self, value: float) -> None:
        v = float(value)
        self._buf.append(v)
        self._trend.add_data_point(v)

    def predict_next(self) -> float:
        n = len(self._buf)
        if n == 0:
            return 0.0
        if n < 2 * self.order + 2:
            # Not enough rows for a stable lag regression yet.
            return self._trend.predict_next()
        y = np.asarray(self._buf, dtype=np.float64)
        p = self.order
        # Lag matrix: row t predicts y[t] from [1, y[t-1] ... y[t-p]].
        rows = n - p
        X = np.empty((rows, p + 1))
        X[:, 0] = 1.0
        for i in range(1, p + 1):
            X[:, i] = y[p - i: n - i]
        target = y[p:]
        # Ridge-regularised normal equations: the lstsq of a nearly
        # constant series is rank-deficient and would swing the forecast.
        A = X.T @ X + self.ridge * np.eye(p + 1)
        try:
            coef = np.linalg.solve(A, X.T @ target)
        except np.linalg.LinAlgError:
            return self._trend.predict_next()
        nxt = coef[0] + float(coef[1:] @ y[-1: -p - 1: -1])
        # Load is nonnegative and a one-step forecast should never
        # explode past the observed envelope (an unstable fit on a short
        # noisy window can): clamp to [0, 2 * max seen in window].
        return float(min(max(nxt, 0.0), 2.0 * y.max()))


def make_predictor(kind: str = "moving_average", **kw):
    if kind == "constant":
        return ConstantPredictor()
    if kind == "moving_average":
        return MovingAveragePredictor(**kw)
    if kind == "trend":
        return TrendPredictor(**kw)
    if kind == "ar":
        return ARPredictor(**kw)
    raise ValueError(f"unknown predictor {kind!r} "
                     "(have: constant, moving_average, trend, ar)")
