"""launches_per_step.update: the kernels launched inside the port's
``train.update`` spans (the gradient sum, the non-finite guard, fused Adam
and the BN commit), from any thread, per step of the traced slice
(spans.py). Nothing when the trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.kernels_per_unit(t, "train.update")
