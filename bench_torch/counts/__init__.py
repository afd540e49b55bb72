"""The yardstick's arithmetic: published peaks, operations and bytes counted
from a configuration's shapes, and bounds (copied from ``chip_smoke.py``'s
``bound``, ``train_step_flops`` and ``crf_bounds``)."""
