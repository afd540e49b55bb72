"""mean_field_fused_pct: the share of the device CRF's mean-field
iterations that ran as the hand-written kernel ``mean_field_step``: 100 ×
the kernels named like it launched inside ``crf.mean_field`` spans (one span
a chunk, spans.py) over ``iters`` (``crf_params[5]``) × those spans, in %.
0 where the spans hold other kernels (the library's M @ Q, conv and
softmax); nothing when the trace holds no such span."""

from bench_torch import spans


def read(t):
    chunks = spans.ops(t.trace, "crf.mean_field")
    if not chunks:
        return None
    launches = sum(1 for found in chunks for d in found
                   if d[1] == "kernel" and "mean_field_step" in d[0])
    return 100.0 * launches / (int(t.cell.config["crf_params"][5]) * len(chunks))
