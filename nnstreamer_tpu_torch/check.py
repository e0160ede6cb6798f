"""``python -m nnstreamer_tpu_torch.check`` — installation self-check of
the PyTorch/CUDA port (``nnstreamer-tpu-torch-check``).

Counterpart of the JAX package's ``check.py`` (parity target: the
reference's ``nnstreamer-check`` utility): lists the port's registered
elements, filter frameworks, decoder/converter sub-plugins, and the
device inventory of ``utils/hw.py`` ``probe()``, so a deployment can
verify what this installation provides.  It computes nothing on a device.

The port has no native wire codec: its converters and decoders use the
pure-Python one, so ``native_codec`` is ``false`` and
``native_codec_reason`` says why.
"""

from __future__ import annotations

import json
import sys


NATIVE_CODEC_REASON = ("the port keeps the pure-Python wire codec "
                       "(converters/wirefmt.py); it builds no native one")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    as_json = "--json" in argv

    from .converters import list_converters
    from .decoders import list_decoders
    from .filters.registry import list_filters
    from .runtime.registry import list_elements
    from .utils.hw import probe

    info = {
        "elements": list_elements(),
        "filter_frameworks": list_filters(),
        "decoders": list_decoders(),
        "converters": list_converters(),
        "devices": probe(),
    }
    info["native_codec"] = False
    info["native_codec_reason"] = NATIVE_CODEC_REASON
    if as_json:
        print(json.dumps(info, indent=2, default=str))
        return 0
    print("nnstreamer-tpu-torch installation check")
    print(f"- elements ({len(info['elements'])}): "
          + ", ".join(info["elements"]))
    print(f"- filter frameworks: {', '.join(info['filter_frameworks'])}")
    print(f"- decoders: {', '.join(info['decoders'])}")
    print(f"- converters: {', '.join(info['converters'])}")
    print(f"- native codec: no ({NATIVE_CODEC_REASON})")
    for platform, devs in info["devices"].items():
        kinds = {d["kind"] for d in devs}
        print(f"- {platform}: {len(devs)} device(s) ({', '.join(kinds)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
