"""pinned_copy_pct.video: the share of the traced slice's copies between
host and card that move pinned host memory: 100 × the device time of the
``gpu_memcpy`` operations named ``HtoD`` or ``DtoH`` whose name says
``Pinned``, over the device time of all of them, in %. Copies on the card
(``DtoD``) are left out. Nothing when the slice holds no such copy."""


def read(t):
    copies = [(name, dur) for name, cat, _, dur, _ in t.trace.device
              if cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name)]
    total = sum(dur for _, dur in copies)
    if total <= 0:
        return None
    return 100.0 * sum(dur for name, dur in copies if "Pinned" in name) / total
