"""Panels and the GIF (counterpart of critic_vae_tpu/viz); Pillow is
imported only by the functions that draw."""
