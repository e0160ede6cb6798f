"""Process start to the start of the timed window: imports, kernel
load (and build, on a first run), weights and frames, the pipeline's
start, the warm-up windows."""


def read(run):
    return run.setup_s
