"""The one traffic generator: a traffic file's parameters and the seed
→ the frames a cell sends.

A traffic file (``traffic/<name>.json``) gives:

- ``source``: the name of the module that puts the frames into the
  pipeline, ``sources/<source>.py`` (see ``sources/__init__.py``);
- ``batch``: frames a window; ``pool_windows``: distinct windows, sent
  in turn;
- ``warmup_windows``: windows run in set-up before the timed window;
- ``check_windows``: windows of the timed window whose results are held
  against the reference, drawn from the seed (the first always);
- ``profile_windows``: windows profiled after the timed window in a
  ``--trace 1`` run.

Further keys are the source's own.  The frames are uniform random uint8
pixels of the configuration's image size, drawn from the seed on the
run's device (a tenth of the time a draw on the host takes) and handed
over in host memory, where the sources take them and the reference
reads the same bytes.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench.reference.common import generator


def frame_pool(cfg, traffic, seed: int, device) -> List[np.ndarray]:
    """The pool's windows, uint8 (batch, size, size, 3), in host
    memory."""
    size, batch = int(cfg["image_size"]), int(traffic["batch"])
    g = generator(seed, "frames", device)
    return [torch.randint(0, 256, (batch, size, size, 3), generator=g,
                          dtype=torch.uint8, device=device).cpu().numpy()
            for _ in range(int(traffic["pool_windows"]))]
