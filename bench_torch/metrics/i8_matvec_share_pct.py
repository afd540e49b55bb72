"""i8_matvec_share_pct: the int8 build's product's share of its mean
field: 100 × the device time of the kernels named like ``matvec_i8`` (B4)
launched inside ``crf.mean_field`` spans over the device time of every
operation launched there (B4, and around it the normalizers' scalings,
the bf16 cast, the spatial message, the softmax; spans.py), in %. What the
rest leaves of the iteration's time: a fused int8 step would raise it
toward 100. Nothing when the trace holds no such span or no B4 kernel in
them."""

from bench_torch import spans


def read(t):
    found = [d for ops in spans.ops(t.trace, "crf.mean_field") or () for d in ops]
    b4 = sum(d[3] for d in found if d[1] == "kernel" and "matvec_i8" in d[0])
    if not b4:
        return None
    return 100.0 * b4 / sum(d[3] for d in found)
