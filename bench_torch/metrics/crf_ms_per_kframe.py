"""crf_ms_per_kframe: the device time of the operations launched inside
the port's ``video.crf`` spans (the device CRF of ``eval_episode``: B2's
builds and the mean fields of every chunk), per 1,000 frames of the traced
slice, in ms (spans.py). Nothing when the trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.ms_per_kframe(t, "video.crf")
