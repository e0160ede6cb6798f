"""SAM's whole step against the card's dense bf16 peak: the cost module's
operations a frame (``cost/sam.py``) times the frames completed in the
timed window, over its seconds times the peak, in percent, as
``step_mfu`` reads it."""

from portbench.metrics.step_mfu import read  # noqa: F401
