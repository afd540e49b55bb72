"""device_stage_ms_per_kframe: the device time of the operations launched
inside the port's ``video.device_stage`` spans (``eval_episode``'s critic,
encode, both decodes and B1, chunk by chunk), per 1,000 frames of the
traced slice, in ms (spans.py: launches on any thread, by correlation id).
Nothing when the trace holds no such span."""

from bench_torch import spans


def read(t):
    return spans.ms_per_kframe(t, "video.device_stage")
