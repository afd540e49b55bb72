"""b3_roofline_pct: kernel B3's (the int8 build's K8 store's) share of its
roofline. The bound is the larger of its bytes over the HBM rate and its
operations over the float32 peak at the cell's frames a launch: B2's count
(counts/bytes.py::b2) at 1 byte an entry, the frames read once and K8
written once (1.074 GB, 0.321 ms at 64 frames of 64x64); the row sums'
1 MB is left out. The time is the mean device time a launch: B3's
operations (its row-sum memset, the feature planes, ``i8_tile_kernel``)
launched inside a ``crf.build`` span (one a chunk, spans.py) that holds an
``i8_tile_kernel``; the normalizers computed after it in the same span are
left out. Nothing when the trace holds no such span."""

from bench_torch import spans
from bench_torch.counts import bytes as nbytes, peaks

B3_KERNELS = ("i8_tile_kernel", "tile_feats_kernel")


def read(t):
    launches = []
    for found in spans.ops(t.trace, "crf.build") or ():
        if any("i8_tile_kernel" in d[0] for d in found):
            launches.append([d for d in found if d[1] == "gpu_memset"
                             or any(k in d[0] for k in B3_KERNELS)])
    if not launches:
        return None
    mean_s = sum(d[3] for ops in launches for d in ops) / len(launches) / 1e6
    cfg = t.cell.config
    nb, ops = nbytes.b2(int(cfg["crf_frames_per_launch"]), int(cfg["frame_size"]) ** 2,
                        m_bytes=1)
    return 100.0 * peaks.bound_s(nb, ops) / mean_s
