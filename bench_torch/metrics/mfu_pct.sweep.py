"""mfu_pct.sweep: the threshold sweep's share of the card's peak over the
traced slice of episodes. Time at peak is the frames' operations, counted
from the configuration's shapes (counts/sweep.py::stages: the nets' convs
at the TF32 peak, their linears at float32's, the 26-lane mean field's
M @ Q at bf16's; ~9.8 µs a frame at ``ref64-sweep-f32``), each stage at the
peak of the precision it runs in; the share is that time over the slice's
wall time, in %."""

from bench_torch.counts import peaks, sweep


def read(t):
    if t.window_s <= 0 or t.frames <= 0:
        return None
    stages = sweep.stages(t.cell.config, bool(t.cell.traffic["run_crf"]))
    at_peak = t.frames * peaks.seconds_at_peak(stages)
    return 100.0 * at_peak / (t.window_s * t.cell.chips)
