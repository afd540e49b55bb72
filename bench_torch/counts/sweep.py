"""Operations of the threshold sweep (``threshold_sweep``), counted from a
configuration's shapes, the same whatever implements them (a multiply-add
is two operations): flops.py::video_stages with the mean field's lanes in
the labels' place, so its M @ Q runs over all the sweep's lanes at once
(P = ``crf_lanes``: 2 labels × 13 thresholds, 26 at ``ref64-sweep-f32``).
The thresholds, their counts, the spatial message and the softmax are
elementwise and left out."""

from __future__ import annotations

from typing import Dict, List, Tuple

from bench_torch.counts import flops


def stages(cfg: Dict, run_crf: bool) -> List[Tuple[float, str]]:
    """(operations a frame, precision) of the sweep."""
    return flops.video_stages({**cfg, "crf_labels": cfg["crf_lanes"]}, run_crf)
