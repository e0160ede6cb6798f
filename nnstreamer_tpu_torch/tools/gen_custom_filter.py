#!/usr/bin/env python
"""Scaffold generator for the port's custom tensor_filter sub-plugins.

Counterpart of the JAX package's ``tools/gen_custom_filter.py``.  Parity
target: the reference's ``tools/development/``
``nnstreamerCodeGenCustomFilter.py`` — generates a ready-to-edit custom
filter skeleton.  This one emits the Python3 script-class form
(``tensor_filter framework=python3 model=<file>.py``) or the
register_custom_easy callable form of ``nnstreamer_tpu_torch``
(``filters/custom.py``); both take and return numpy arrays.

Usage:
    python -m nnstreamer_tpu_torch.tools.gen_custom_filter NAME [--easy] [--in 3:224:224:1]
        [--in-type float32] [--out 1001:1] [--out-type float32]
        [--dir OUTDIR]
"""

import argparse
import os

SCRIPT_TEMPLATE = '''"""Custom tensor_filter: {name}.

Use in a pipeline:
    ... ! tensor_filter framework=python3 model={name}.py ! ...
"""

import numpy as np


class CustomFilter:
    def getInputDim(self):
        # (dims innermost-first, numpy dtype) per input tensor
        return [("{in_dims}", np.{in_type})]

    def getOutputDim(self):
        return [("{out_dims}", np.{out_type})]

    def setInputDim(self, dims):
        # optional: accept a reshape request; raise to refuse
        raise NotImplementedError

    def invoke(self, inputs):
        """inputs: list of numpy arrays; return list of numpy arrays."""
        x = inputs[0]
        # TODO: your computation here
        y = x.astype(np.{out_type})
        return [y]
'''

EASY_TEMPLATE = '''"""Custom-easy tensor_filter: {name}.

Register then use as:
    register()
    ... ! tensor_filter framework=custom-easy model={name} ! ...
"""

import numpy as np

from nnstreamer_tpu_torch.core import TensorsSpec
from nnstreamer_tpu_torch.filters.custom import register_custom_easy


def {name}_invoke(inputs):
    """inputs: list of numpy arrays; return list of numpy arrays."""
    x = inputs[0]
    # TODO: your computation here
    return [x.astype(np.{out_type})]


def register():
    return register_custom_easy(
        "{name}", {name}_invoke,
        in_spec=TensorsSpec.parse("{in_dims}", "{in_type}"),
        out_spec=TensorsSpec.parse("{out_dims}", "{out_type}"))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--easy", action="store_true",
                    help="emit the register_custom_easy form")
    ap.add_argument("--in", dest="in_dims", default="3:224:224:1")
    ap.add_argument("--in-type", default="float32")
    ap.add_argument("--out", dest="out_dims", default="1001:1")
    ap.add_argument("--out-type", default="float32")
    ap.add_argument("--dir", default=".")
    args = ap.parse_args(argv)

    tmpl = EASY_TEMPLATE if args.easy else SCRIPT_TEMPLATE
    code = tmpl.format(name=args.name, in_dims=args.in_dims,
                       in_type=args.in_type, out_dims=args.out_dims,
                       out_type=args.out_type)
    path = os.path.join(args.dir, f"{args.name}.py")
    if os.path.exists(path):
        raise SystemExit(f"refusing to overwrite {path}")
    with open(path, "w") as f:
        f.write(code)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
