"""The transform's ``scale_bias_cast`` kernel's share of its roofline
(``roofline.py``)."""

from portbench.roofline import share

KERNELS = ("scale_bias_cast_kernel",)


def read(run):
    return share(run, KERNELS, "prologue")
