"""score_idle_pct.video: the card's idle time inside the port's
``video.score`` spans (the host's IoU of the masks against the ground
truth) as a share of the traced slice's wall time, in %: a part of
``device_idle_pct.video``, on its denominator (spans.py). Nothing when the
trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.idle_pct(t, "video.score")
