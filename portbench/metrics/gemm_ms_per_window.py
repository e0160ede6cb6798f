"""Kernel time a window launched for the dense products alone
(``nns:dense:gemm``), over the second traced stretch (``spans.py``)."""

from portbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.ms_per_window(("nns:dense:gemm",))
