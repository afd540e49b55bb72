"""GIF episode writer (counterpart of critic_vae_tpu/viz/gif.py;
reference: create_video, vae_utility.py:85-104). Pillow is imported inside
:func:`write_gif`."""

from __future__ import annotations

import os
from io import BytesIO
from typing import Sequence


def pillow_available() -> bool:
    """Whether Pillow can be imported (`video` draws no GIF without it)."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def write_gif(frames: Sequence, out_path: str, duration_ms: int = 100) -> str:
    """Write Pillow images to an endlessly looping GIF (100 ms a frame).
    Each frame is GIF-encoded on its own first, as the reference does, so
    every frame keeps its own palette."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    encoded = []
    for f in frames:
        buf = BytesIO()
        f.save(buf, format="GIF")
        encoded.append(Image.open(buf))
    encoded[0].save(out_path, format="GIF", duration=duration_ms, save_all=True, loop=0,
                    append_images=encoded[1:])
    return out_path
