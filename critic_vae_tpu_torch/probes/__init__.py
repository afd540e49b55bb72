"""Hopper probes of the fused front-end kernel design (counterparts of
examples/mosaic_caps_probe.py and examples/mosaic_copy_floor_probe.py):
``caps_probe`` (P1) and ``copy_floor_probe`` (P2), each runnable with
``python -m``."""
