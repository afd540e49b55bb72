"""epilogue_ms_per_kframe: the device time of the operations launched
inside the port's ``block.epilogue`` spans (each conv block's post-conv
chain in the mask stage: bias, BatchNorm, pool and activation, or the
decoder's interleave, bias and ReLU; ops/epilogue.py), per 1,000 frames of
the traced slice, in ms (spans.py). Nothing when the trace holds no such
span."""

from bench_torch import spans


def read(t):
    return spans.ms_per_kframe(t, "block.epilogue")
