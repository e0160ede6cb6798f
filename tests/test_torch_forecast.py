from torch_replay import replay
replay("test_forecast.py", globals())


# -- the port against the JAX package on the same series --------------------

import dataclasses as _dc  # noqa: E402

import numpy as _np  # noqa: E402

import nnstreamer_tpu.obs.forecast as _jf  # noqa: E402
import nnstreamer_tpu_torch.obs.forecast as _tf  # noqa: E402


def _seeded_series(seed, n):
    """A trend with noise and a few outliers, at jittered timestamps."""
    rng = _np.random.default_rng(seed)
    ts = _np.cumsum(rng.uniform(0.02, 0.08, n))
    vs = 3.0 + 0.7 * ts + rng.normal(0.0, 0.05, n)
    vs[rng.integers(0, n, 3)] += rng.normal(0.0, 4.0, 3)
    return [(float(t), float(v)) for t, v in zip(ts, vs)]


@pytest.mark.parametrize("seed", range(8))
def test_fit_and_crossing_equal_the_jax_floats(seed):
    """fit_trend, forecast_crossing and capacity_headroom give the very
    same floats as the JAX module on seeded series."""
    pts = _seeded_series(seed, 12 + 5 * seed)
    jfit, tfit = _jf.fit_trend(pts), _tf.fit_trend(pts)
    assert _dc.asdict(tfit) == _dc.asdict(jfit)
    for op in _jf.ORDERED_OPS:
        for thr in (tfit.level - 1.0, tfit.level + 2.5):
            for horizon in (0.5, 30.0):
                assert _tf.forecast_crossing(tfit, thr, op, horizon) == \
                    _jf.forecast_crossing(jfit, thr, op, horizon)
    args = (100.0 + seed, 140.0 + 7 * seed)
    assert _tf.capacity_headroom(*args, mfu=0.2, mfu_ceiling=0.6) == \
        _jf.capacity_headroom(*args, mfu=0.2, mfu_ceiling=0.6)
    assert _tf.capacity_headroom(*args, occupancy=0.5) == \
        _jf.capacity_headroom(*args, occupancy=0.5)
