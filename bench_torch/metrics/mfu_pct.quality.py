"""mfu_pct.quality: the saliency stage's share of the card's float32 peak
over the traced slice of episodes: the frames' operations
(counts/saliency.py::frame, from the configuration's shapes: each test-time
view's critic forward, its backward to the LayerCAM block and its
upsample) at the float32 peak (the stage runs with TF32 off), over the
slice's wall time, in %."""

from bench_torch.counts import peaks, saliency


def read(t):
    if t.window_s <= 0 or t.frames <= 0:
        return None
    at_peak = t.frames * saliency.frame(t.cell.config) / peaks.FLOPS["float32"]
    return 100.0 * at_peak / (t.window_s * t.cell.chips)
