"""saliency_idle_pct.video: the card's idle time inside the port's
``saliency.view``, ``saliency.upsample`` and ``saliency.combine`` spans
(which follow one another and never overlap) as a share of the traced
slice's wall time, in %: how far the host's launches of the saliency stage
hold the card back, a part of ``device_idle_pct.video`` on its denominator
(spans.py). Nothing when the trace holds none of these spans."""

from bench_torch import spans

SPANS = ("saliency.view", "saliency.upsample", "saliency.combine")


def read(t):
    found = [v for v in (spans.idle_pct(t, name) for name in SPANS) if v is not None]
    return sum(found) if found else None
