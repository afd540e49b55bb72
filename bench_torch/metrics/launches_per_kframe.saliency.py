"""launches_per_kframe.saliency: the kernels launched inside the port's
``saliency.view``, ``saliency.upsample`` and ``saliency.combine`` spans,
from any thread (autograd's backward launches from its own), per 1,000
frames of the traced slice (spans.py). Nothing when the trace holds none
of these spans or no kernel."""

from bench_torch import spans

SPANS = ("saliency.view", "saliency.upsample", "saliency.combine")


def read(t):
    found = [spans.ops(t.trace, name) for name in SPANS]
    found = [per_span for per_span in found if per_span is not None]
    if not found or t.frames <= 0 or not t.trace.kernels():
        return None
    kernels = sum(1 for per_span in found for ops in per_span for d in ops if d[1] == "kernel")
    return kernels / (t.frames / 1e3)
