"""epilogue_fused_pct.video: how often a conv block's epilogue (in the
video cells, the mask stage's) ran as the hand-written kernel: 100 × the
kernels whose name holds ``block_epilogue`` launched inside
``block.epilogue`` spans (one span a block's epilogue, spans.py) over those
spans, in %. 0 where the spans hold ATen's elementwise and pool kernels
alone; nothing when the trace holds no such span."""

from bench_torch import spans


def read(t):
    blocks = spans.ops(t.trace, "block.epilogue")
    if not blocks:
        return None
    launches = sum(1 for found in blocks for d in found
                   if d[1] == "kernel" and "block_epilogue" in d[0])
    return 100.0 * launches / len(blocks)
