"""device_idle_pct.video: the share of the traced slice of episodes in
which no operation (kernel, copy or set) ran on the card: one minus the
union of their intervals over the slice's wall time, in %."""


def read(t):
    if t.window_s <= 0 or not t.trace.device:
        return None
    return 100.0 * (1.0 - t.trace.busy_s() / t.window_s)
