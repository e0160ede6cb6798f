"""Plain references, one module per architecture: ``make_tree(cfg, seed,
device)`` draws the weights both sides get, ``judge(...)`` holds the
program's sampled results against the reference and returns the
compared numbers, ``control_outputs(...)`` computes the reference in the
precision below the configuration's, in the program's place."""
