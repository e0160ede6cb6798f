"""Kernel time a window launched inside the dense products' epilogues:
the bias adds (``nns:dense:bias``), the GELU (``nns:vit:gelu``) and the
residual adds (``nns:vit:residual``), over the second traced stretch
(``spans.py``)."""

from portbench import spans

SPANS = ("nns:dense:bias", "nns:vit:gelu", "nns:vit:residual")


def read(run):
    s = spans.of(run)
    return None if s is None else s.ms_per_window(SPANS)
