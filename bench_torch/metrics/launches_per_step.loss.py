"""launches_per_step.loss: the kernels launched inside the port's
``train.loss`` spans (MS-SSIM + KLD and the optional terms), from any
thread, per step of the traced slice (spans.py). Nothing when the trace
holds no such span."""

from bench_torch import spans


def read(t):
    return spans.kernels_per_unit(t, "train.loss")
