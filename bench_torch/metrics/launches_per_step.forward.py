"""launches_per_step.forward: the kernels launched inside the port's
``train.forward`` spans (the batch's normalisation, the critic's labels and
the VAE's forward), from any thread, per step of the traced slice
(spans.py). Nothing when the trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.kernels_per_unit(t, "train.forward")
