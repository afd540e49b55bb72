"""readback_idle_pct.video: the card's idle time inside the port's
``video.readback`` spans (the copies of maps, masks and scores to the host)
as a share of the traced slice's wall time, in %: a part of
``device_idle_pct.video``, on its denominator (spans.py). Nothing when the
trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.idle_pct(t, "video.readback")
