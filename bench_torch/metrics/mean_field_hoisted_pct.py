"""mean_field_hoisted_pct: the share of the device CRF's mean-field steps
that took their spatial message from the hand-written kernel
``spatial_message``, launched before each step, rather than summing it in
the step's own epilogue: 100 × the kernels named like it launched inside
``crf.mean_field`` spans (one span a chunk, spans.py) over the kernels
named like ``mean_field_step`` there, in %. 100 where every step had its
launch, 0 where every step summed the message itself; nothing when the
trace holds no such span or no step kernel in them. It tells which path
ran, not how fast: a change of path reads as a change here whatever its
speed."""

from bench_torch import spans


def read(t):
    chunks = spans.ops(t.trace, "crf.mean_field")
    if not chunks:
        return None
    kernels = [d[0] for found in chunks for d in found if d[1] == "kernel"]
    steps = sum(1 for name in kernels if "mean_field_step" in name)
    if not steps:
        return None
    return 100.0 * sum(1 for name in kernels if "spatial_message" in name) / steps
