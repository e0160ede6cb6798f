"""The global blocks' biased ``flash_attention`` against its roofline: the
least time a window's global launches could take (``cost/sam.py``
``attention_bound_s``) over the kernel time a window under
``nns:sam:attn_global`` in the second traced stretch (``spans.py``), in
percent."""

from portbench import spans


def read(run):
    s = spans.of(run)
    if s is None or run.peaks is None:
        return None
    ms = s.ms_per_window(("nns:sam:attn_global",))
    if not ms:
        return None
    return 100.0 * run.cost.attention_bound_s(run.cfg, run.batch, run.peaks,
                                              "global") * 1e3 / ms
