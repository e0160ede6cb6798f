"""Kernels the card ran wholly inside the profiled stretch, over the
windows that completed in it: the launches the host dispatches for a
window (the transform, the model's eager operations and the hand-written
kernels), which fusion, a merged kernel or a captured graph cut."""


def read(run):
    t = run.trace
    if t is None or not t.windows:
        return None
    return len(t.kernels()) / t.windows
