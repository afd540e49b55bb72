"""saliency_ms_per_kframe: the device time of the operations launched
inside the port's ``saliency.view``, ``saliency.upsample`` and
``saliency.combine`` spans (ops/saliency.py: each view's critic forward,
backward and LayerCAM map, its upsample, and its mapping back and minimum),
from any thread, per 1,000 frames of the traced slice, in ms (spans.py).
Nothing when the trace holds none of these spans."""

from bench_torch import spans

SPANS = ("saliency.view", "saliency.upsample", "saliency.combine")


def read(t):
    found = [v for v in (spans.ms_per_kframe(t, name) for name in SPANS) if v is not None]
    return sum(found) if found else None
