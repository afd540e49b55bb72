"""sweep_threshold_ms_per_kframe: the device time of the operations
launched inside the port's ``sweep.threshold`` spans (``threshold_sweep``'s
chunk by chunk normalisation, its masks at every threshold and their
counts against the ground truth), per 1,000 frames of the traced slice, in
ms (spans.py: launches on any thread, by correlation id). Nothing when the
trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.ms_per_kframe(t, "sweep.threshold")
