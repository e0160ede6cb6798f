"""Kernel time a window launched for SAM's window padding, partition,
unpartition and crop (``nns:sam:window``), over the second traced stretch
(``spans.py``)."""

from portbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.ms_per_window(("nns:sam:window",))
