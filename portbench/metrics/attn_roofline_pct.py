"""``flash_attention``'s share of its roofline (``roofline.py``)."""

from portbench.roofline import share

KERNELS = ("flash_attention_bf16_kernel", "flash_attention_f32_kernel")


def read(run):
    return share(run, KERNELS, "attention")
