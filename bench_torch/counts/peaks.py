"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), as ``chip_smoke.py`` uses them. A card set
below 700 W reaches less; the result lines print the card's limit."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bfloat16": 989e12,   # tensor cores
    "tf32": 495e12,       # tensor cores, float32 operands rounded to TF32
    "float32": 67e12,     # outside the tensor cores
}


def bound_s(nbytes: float, ops) -> float:
    """The least time the card could take: the larger of ``nbytes`` over
    the HBM rate and the operations ``ops`` ((count, precision) pairs) over
    their peaks (``chip_smoke.py::bound``)."""
    return max(nbytes / HBM_BYTES_PER_S, sum(count / FLOPS[p] for count, p in ops))


def seconds_at_peak(stages) -> float:
    """The time at peak of (flops, precision) stages: each at its own peak."""
    return sum(flops / FLOPS[p] for flops, p in stages)
