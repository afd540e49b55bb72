"""mfu_pct.train: the whole train step's share of the card's peak over the
traced slice of steps: the steps' operations at the global batch
(counts/flops.py::train_step, from the configuration's shapes) at the
float32 peak (the step runs with TF32 off), over the slice's wall time
and the cards the cell uses, in %."""

from bench_torch.counts import flops, peaks


def read(t):
    if t.window_s <= 0 or t.units <= 0:
        return None
    ops = t.units * flops.train_step(t.cell.config, int(t.cell.traffic["batch_size"]))
    return 100.0 * ops / peaks.FLOPS["float32"] / (t.window_s * t.cell.chips)
