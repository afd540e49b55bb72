"""mean_field_roofline_pct: the device CRF's mean field's share of its
roofline. The bound is ``iters`` reads of the chunk's bilateral matrix M at
the HBM rate (counts/peaks.py): iters x the frames a chunk x N^2 entries x
the bytes of M's dtype, N the pixels of a frame (10 x 64 x 4,096^2 x 2 B
= 21.47 GB, 6.41 ms at ``ref64-video-f32``); Q, the unaries and the
spatial conv's few MB are left out, as a bound wants. The time is the mean
device time of the operations launched inside a ``crf.mean_field`` span
(one span a chunk: M @ Q, the spatial message and the softmax, ``iters``
times; spans.py). Nothing when the trace holds no such span."""

from bench_torch import spans
from bench_torch.counts import peaks

M_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(cfg) -> float:
    """The least time of one chunk's mean field at the configuration's
    sizes: its reads of M over the HBM rate."""
    n = int(cfg["frame_size"]) ** 2
    nbytes = (int(cfg["crf_params"][5]) * int(cfg["crf_frames_per_launch"]) * n * n
              * M_BYTES[cfg["crf_m_dtype"]])
    return peaks.bound_s(nbytes, [])


def read(t):
    chunks = [found for found in spans.ops(t.trace, "crf.mean_field") or () if found]
    if not chunks:
        return None
    mean_s = sum(d[3] for found in chunks for d in found) / len(chunks) / 1e6
    return 100.0 * bound_s(t.cell.config) / mean_s
