"""Mask-stage ops: the diff-mask kernel, the critic's saliency maps and
their upsample, normalisation, thresholds, IoU."""
