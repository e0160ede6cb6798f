"""Frames done in the timed window, divided by its seconds: every window
whose result completed at the sink (its CUDA fence done) inside it, and
the window under way at its close by the share of its time that fell
inside (``harness.frames_done``)."""


def read(run):
    return run.window.frames / run.window.seconds
