"""One reader a metric: ``metrics/<name>.py`` defines ``read(run)``,
which returns the metric's value from ``run`` (``harness.Run``: the
timed window's host-clock record, the profiled stretch's trace summary,
the configuration, its cost counts and the card's peaks), or None when
it finds nothing to read, and the run leaves the metric out."""
