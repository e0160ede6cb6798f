"""Kernel time a window launched inside the ViT's layer norms
(``nns:vit:ln``, the final one included), over the second traced
stretch (``spans.py``), counted as ``device_ms_per_window`` counts."""

from portbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.ms_per_window(("nns:vit:ln",))
