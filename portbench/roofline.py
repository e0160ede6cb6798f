"""A hand-written kernel's share of its roofline over the profiled
stretch: for each launch wholly inside it, the least time the card could
take (the larger of its operations over the bf16 peak and its bytes over
the memory bandwidth, from the cost module), summed, over the launches'
measured time, in percent.  Each metric file names its kernels and their
cost."""


def share(run, kernels, cost_key):
    t = run.trace
    if t is None or run.peaks is None:
        return None
    launches = t.kernels(kernels)
    costs = run.cost.kernel_costs(run.cfg, run.batch)
    if not launches or cost_key not in costs:
        return None
    flops, nbytes = costs[cost_key]
    bound_s = max(flops / run.peaks["bf16_flops_per_s"],
                  nbytes / run.peaks["hbm_bytes_per_s"])
    return 100.0 * bound_s * len(launches) \
        / (sum(e.dur_us for e in launches) / 1e6)
