"""Device time of every kernel in the profiled stretch, over the windows
that completed in it."""


def read(run):
    t = run.trace
    if t is None or not t.windows:
        return None
    return sum(e.dur_us for e in t.events if e.cat == "kernel") / 1e3 \
        / t.windows
