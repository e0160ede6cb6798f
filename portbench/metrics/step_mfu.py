"""The whole step's share of the card's dense bf16 peak: the cost
module's operations a frame times the frames completed in the timed
window, over the window's seconds times the peak, in percent."""


def read(run):
    if run.peaks is None or not run.window.frames:
        return None
    flops = run.cost.flops_per_frame(run.cfg) * run.window.frames
    return 100.0 * flops / (run.window.seconds
                            * run.peaks["bf16_flops_per_s"])
