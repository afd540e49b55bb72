"""launches_per_step.backward: the kernels launched inside the port's
``train.backward`` spans (autograd's backward, whose kernels its device
thread launches), from any thread, per step of the traced slice (spans.py).
Nothing when the trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.kernels_per_unit(t, "train.backward")
