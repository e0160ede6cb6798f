"""Kernel time a window launched for SAM's relative-position tables (the
gather of ``rel_pos_h``/``rel_pos_w`` and the two products, ``nns:sam:relpos``),
over the second traced stretch (``spans.py``)."""

from portbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.ms_per_window(("nns:sam:relpos",))
