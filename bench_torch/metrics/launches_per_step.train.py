"""launches_per_step.train: the kernels the card ran over the traced slice
of training steps, a step (rank 0's card under data parallelism)."""


def read(t):
    kernels = t.trace.kernels()
    if t.units <= 0 or not kernels:
        return None
    return len(kernels) / t.units
