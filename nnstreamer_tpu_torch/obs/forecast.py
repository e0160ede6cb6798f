"""Short-horizon forecasting over the watch store's rings.

Every alert the watchdog (:mod:`.watch`) has raised so far is
*reactive*: the SLO burn fires after latency already burned budget, the
queue-saturation rule after the queue already filled.  On a serving
fleet the interesting question is usually a few seconds earlier —
"is this series GOING to cross the line?".  This module is the math
behind the fourth rule kind, ``forecast``:

- :func:`fit_trend` — a robust linear fit over a ring tail: the slope
  is the Theil–Sen estimator (median of all pairwise slopes, immune to
  a third of the points being garbage), the level a median-projected
  intercept at the window's last timestamp, and the residual scale a
  MAD band around the fitted line;
- :func:`forecast_crossing` — given a fit, a threshold and a horizon:
  the predicted value at the horizon, the ETA of the crossing, and
  whether the rule should fire.  A trend only counts when the
  projected move clears the residual noise band
  (``SIGNIFICANCE_SIGMAS`` robust sigmas) — a flat or merely noisy
  series never fires, which is what keeps the predictive layer's
  false-positive rate at zero on steady traffic (the capacity bench
  pins exactly that);
- :func:`capacity_headroom` — the arrival-vs-capacity join: sustainable
  rate extrapolated from live MFU against its roofline ceiling
  (:mod:`.xlacost`), falling back to pool window occupancy, compared
  with the *forecast* arrival rate.  Exported as
  ``nns_capacity_headroom`` and the ``/healthz`` capacity summary.

Everything here is pure computation on ``(ts, value)`` lists — no
thread, no scraping: the watch sampler feeds it on its existing tick
and publishes the results through :data:`FORECASTS` (the snapshot v9
``forecasts`` table) and the ``nns_forecast_*`` gauges.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
from typing import Dict, Iterable, List, Optional, Tuple

#: cap on points fed to the pairwise-slope fit — the estimator is
#: O(n^2) pairs, and 64 points keeps one fit in the tens of
#: microseconds while still spanning a minute of 1 Hz sampling
MAX_FIT_POINTS = 64

#: fewer points than this is a line through noise, not a trend
MIN_FIT_POINTS = 4

#: the projected move over the horizon must clear this many robust
#: sigmas (1.4826 x residual MAD) before a crossing is believed
SIGNIFICANCE_SIGMAS = 3.0

#: horizon of the capacity-headroom arrival forecast when no forecast
#: rule pins a longer one
HEADROOM_HORIZON_S = 30.0

#: cap on the capacity extrapolation multiplier: a pool idling at 0.1%
#: MFU does not credibly promise 1000x its current throughput
MAX_SCALE_OUT = 100.0

#: the ordered comparisons a forecast can project through ("=="/"!="
#: have no crossing direction — the rule grammar rejects them)
ORDERED_OPS = (">", ">=", "<", "<=")

_CMP = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


@dataclasses.dataclass(frozen=True)
class TrendFit:
    """Robust linear fit of one ring tail."""

    slope: float     #: units per second (Theil–Sen)
    level: float     #: fitted value AT the window's last timestamp
    sigma: float     #: residual scale, 1.4826 x MAD (0 = perfect line)
    n: int           #: points fitted
    t_last: float    #: timestamp the level is anchored to

    def at(self, dt_s: float) -> float:
        """Predicted value ``dt_s`` seconds past the window end."""
        return self.level + self.slope * dt_s


def fit_trend(points: Iterable[Tuple[float, float]],
              max_points: int = MAX_FIT_POINTS) -> Optional[TrendFit]:
    """Theil–Sen slope + median-projected level + residual MAD over the
    trailing ``max_points`` of ``points`` (``(ts, value)`` pairs).
    None below :data:`MIN_FIT_POINTS` — too little history to call a
    trend."""
    pts = list(points)[-int(max_points):]
    if len(pts) < MIN_FIT_POINTS:
        return None
    t_last = pts[-1][0]
    slopes: List[float] = []
    for i, (ti, vi) in enumerate(pts):
        for tj, vj in pts[i + 1:]:
            if tj > ti:
                slopes.append((vj - vi) / (tj - ti))
    if not slopes:
        return None  # all points share one timestamp
    slope = statistics.median(slopes)
    # robust intercept: project every point to t_last along the slope,
    # take the median — outliers shift it no further than they shifted
    # the slope
    levels = [v - slope * (t - t_last) for t, v in pts]
    level = statistics.median(levels)
    resid = [abs(v - (level + slope * (t - t_last))) for t, v in pts]
    sigma = 1.4826 * statistics.median(resid)
    return TrendFit(slope=slope, level=level, sigma=sigma,
                    n=len(pts), t_last=t_last)


def forecast_crossing(fit: TrendFit, threshold: float, op: str,
                      horizon_s: float,
                      k_sigma: float = SIGNIFICANCE_SIGMAS
                      ) -> Tuple[float, Optional[float], bool]:
    """``(predicted, eta_s, firing)`` for one fitted series against an
    ordered comparison.

    - ``predicted``: the fit extrapolated to the horizon;
    - ``eta_s``: seconds until the fitted line crosses the threshold
      (0 when the current level already satisfies the comparison,
      None when no crossing lies ahead);
    - ``firing``: True only when the crossing is *predicted*, not
      current — the level is still on the safe side, the trend carries
      it across within the horizon, and the projected move clears the
      noise band (``k_sigma`` robust sigmas).  Current violations are
      the plain ``threshold`` rule's job; a flat series (slope 0)
      never fires by construction.
    """
    cmp = _CMP[op]
    predicted = fit.at(horizon_s)
    if cmp(fit.level, threshold):
        return predicted, 0.0, False  # already over: reactive territory
    if fit.slope == 0.0:
        return predicted, None, False
    eta = (threshold - fit.level) / fit.slope
    if eta < 0:
        return predicted, None, False  # trending AWAY from the line
    significant = abs(fit.slope) * horizon_s > k_sigma * fit.sigma
    firing = bool(significant and eta <= horizon_s
                  and cmp(predicted, threshold))
    return predicted, eta, firing


def capacity_headroom(current_fps: float, predicted_fps: float,
                      mfu: Optional[float] = None,
                      mfu_ceiling: Optional[float] = None,
                      occupancy: Optional[float] = None
                      ) -> Optional[dict]:
    """The arrival-vs-capacity join: ``{sustainable_fps, headroom}``.

    Sustainable rate extrapolates the CURRENT measured rate linearly to
    saturation — by live MFU against its roofline ceiling when the
    cost join knows both, else by pool window occupancy (mean frames
    per dispatch over the window size); None when neither signal
    exists (no utilization → no capacity claim, same stance as
    :mod:`.hwspec`).  ``headroom`` is the fraction of sustainable rate
    left over after the *forecast* arrival rate, clamped to [-1, 1]:
    1 = idle, 0 = predicted arrivals exactly saturate, negative =
    predicted overload."""
    if current_fps is None or current_fps <= 0:
        return None
    sustainable = None
    if mfu and mfu_ceiling and mfu > 0:
        sustainable = current_fps * min(mfu_ceiling / mfu, MAX_SCALE_OUT)
    elif occupancy and occupancy > 0:
        sustainable = current_fps * min(1.0 / min(occupancy, 1.0),
                                        MAX_SCALE_OUT)
    if not sustainable or sustainable <= 0:
        return None
    headroom = (sustainable - max(predicted_fps, 0.0)) / sustainable
    return {"sustainable_fps": sustainable,
            "headroom": max(min(headroom, 1.0), -1.0)}


class Forecasts:
    """Process-wide latest-forecast store, the pull side of the
    predictive layer: the watch sampler writes one row per forecast
    rule (and one capacity row per pool) each tick; the registry
    snapshot (v9 ``forecasts`` table), ``/healthz`` and nns-top read
    them back without touching the sampler."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: Dict[str, dict] = {}
        self._capacity: Dict[str, dict] = {}

    def update(self, rule: str, row: dict) -> None:
        with self._lock:
            self._rules[str(rule)] = dict(row)

    def update_capacity(self, pool: str, row: dict) -> None:
        with self._lock:
            self._capacity[str(pool)] = dict(row)

    def snapshot(self) -> dict:
        """{"rules": [...], "capacity": [...]}, sorted for stable
        output."""
        with self._lock:
            rules = [dict(self._rules[k]) for k in sorted(self._rules)]
            cap = [dict(self._capacity[k])
                   for k in sorted(self._capacity)]
        return {"rules": rules, "capacity": cap}

    def reset(self) -> None:
        """Tests/bench only."""
        with self._lock:
            self._rules.clear()
            self._capacity.clear()


#: the store the active watchdog feeds (module-global like TENANT_STATS
#: — there is one snapshot, so there is one forecasts table)
FORECASTS = Forecasts()
