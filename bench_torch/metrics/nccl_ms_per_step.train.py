"""nccl_ms_per_step.train: the device time of the kernels whose name holds
"nccl" (the all-reduces of data parallelism) a training step, on rank 0's
card, in ms. Nothing when the slice ran no such kernel."""


def read(t):
    nccl = [d for d in t.trace.kernels() if "nccl" in d[0].lower()]
    if t.units <= 0 or not nccl:
        return None
    return sum(d[3] for d in nccl) / 1e3 / t.units
