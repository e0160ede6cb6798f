"""The two readings a cell's limits are set from, on the card at the
cell's own size:

    python3 portbench/calibrate.py --workload <cell> --side control \
        --seeds 1 2 3
    python3 portbench/calibrate.py --workload <cell> --side program \
        --seconds 3 --seeds 1 2 ... 12

``control``: for each seed it makes the cell's weights and frame pool as
a run does, puts the plain reference computed in the precision below the
configuration's (float8 operands) in the program's place for as many
windows as a run checks, and judges those outputs as a run judges the
program's.  ``program``: one run of the cell a seed, all in one process
(set-up paid once for the imports), with a short timed window.  Prints
one JSON line a seed with the compared numbers and the limits each
fails.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_numbers(cell, seed: int, device) -> dict:
    """The judge's numbers for the control on ``seed``'s inputs."""
    import torch

    from portbench import harness
    from portbench import traffic as gen

    ref = harness.arch(cell.cfg, "reference")
    tree = ref.make_tree(cell.cfg, seed, device)
    pool = [torch.from_numpy(f)
            for f in gen.frame_pool(cell.cfg, cell.traffic, seed,
                                         device)]
    samples = []
    for k in range(int(cell.traffic["check_windows"])):
        slot = k % len(pool)
        out = ref.control_outputs(tree, cell.cfg, pool[slot], device)
        out["slot"] = slot
        samples.append(out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ref.judge(tree, cell.cfg, samples, lambda s: pool[s], device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("control", "program"),
                    default="control")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from portbench import harness

    harness.use_checkout_caches()
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.resolve(spec, args.workload)
    device = harness.device_of(cell.chips, "cuda")
    limits = cell.cfg["limits"]
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.side == "control":
            numbers = control_numbers(cell, seed, device)
        else:
            out = harness.run_cell(cell, seed, args.seconds, False, t0,
                                   log=lambda *a: None)
            numbers = {k: c["value"] for k, c in out["checks"].items()}
        fails = sorted(k for k, lim in limits.items() if numbers[k] > lim)
        failed_all &= bool(fails)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "side": args.side, "numbers": numbers,
                          "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all or args.side == "program" else 1


if __name__ == "__main__":
    sys.exit(main())
