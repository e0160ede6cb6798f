"""Share of the second traced stretch's kernel time (``spans.py``) whose
launch lies in no leaf span of the program, or is missing from the
trace, in percent: what the per-layer split cannot name."""

from portbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.unspanned_pct()
