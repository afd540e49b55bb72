"""b4_roofline_pct: kernel B4's (the int8 build's K8 @ y product's) share
of its roofline. The bound is the larger of its bytes over the HBM rate and
its operations over the float32 peak at the cell's frames a launch and its
``crf_labels`` lanes (counts/int8.py::b4: K8 read once, the bf16 y read and
the float32 out written, 1.077 GB, 0.321 ms at 64 frames of 64x64 and 2
lanes). The time is the mean device time of the kernels named like
``matvec_i8`` launched inside ``crf.mean_field`` spans (one span a chunk,
one launch an iteration; spans.py). Nothing when the trace holds no such
kernel."""

from bench_torch import spans
from bench_torch.counts import int8, peaks


def read(t):
    kernels = [d for found in spans.ops(t.trace, "crf.mean_field") or () for d in found
               if d[1] == "kernel" and "matvec_i8" in d[0]]
    if not kernels:
        return None
    mean_s = sum(d[3] for d in kernels) / len(kernels) / 1e6
    cfg = t.cell.config
    nb, ops = int8.b4(int(cfg["crf_frames_per_launch"]), int(cfg["frame_size"]) ** 2,
                      int(cfg["crf_labels"]))
    return 100.0 * peaks.bound_s(nb, ops) / mean_s
