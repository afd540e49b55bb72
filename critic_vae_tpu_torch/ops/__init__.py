"""Mask-stage ops: the diff-mask kernel, normalisation, thresholds, IoU."""
