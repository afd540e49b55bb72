"""b2_roofline_pct: kernel B2's (the bilateral build's) share of its
roofline. The bound is the larger of its bytes over the HBM rate and its
operations over the float32 peak at the cell's frames a launch
(counts/bytes.py::b2); the time is the mean device time a launch: the
device operations launched inside the port's ``bilateral_build`` spans
(kernels/build.py::launch_span), matched by correlation id. Nothing when
the trace holds no such span or no launch in it."""

from bench_torch.counts import bytes as nbytes, peaks


def read(t):
    launches = [ops for ops in t.trace.span_kernels("bilateral_build") if ops]
    if not launches:
        return None
    mean_s = sum(d[3] for ops in launches for d in ops) / len(launches) / 1e6
    cfg = t.cell.config
    nb, ops = nbytes.b2(int(cfg["crf_frames_per_launch"]), int(cfg["frame_size"]) ** 2)
    return 100.0 * peaks.bound_s(nb, ops) / mean_s
