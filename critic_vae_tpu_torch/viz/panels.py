"""Annotated panel strips, drawn on the host with Pillow (counterpart of
critic_vae_tpu/viz/panels.py; reference: vae_utility.py:286-322
get_final_frame, :385-390 prepare_rgb_image).

7 panels for the video pipeline with ground truth (orig / recon@pred /
recon@0 / diff / thr-mask / crf / ground truth) with titles, the critic
value and the IoUs burned in; 6 without ground truth; 4 for image eval;
and the inject strip, the original beside its injected reconstructions.
Arrays are NHWC. Pillow is imported only inside the functions that draw,
so the port imports on a machine without it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np

_FONT_CANDIDATES = (
    "/usr/share/fonts/truetype/ubuntu/Ubuntu-R.ttf",  # the reference's hardcode (vae_utility.py:18)
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/liberation/LiberationSans-Regular.ttf",
)

TITLES = (
    "orig img\n+crit val",
    "crit val\ninjected",
    "crit=0\ninjected",
    "difference\nmask",
    "thr-mask\nthr={thr}",
    "thr-mask +\ncrf",
    "ground\ntruth",
)


@functools.lru_cache(maxsize=None)
def font(size: int = 10):
    """The first TrueType font of the candidates, else Pillow's default."""
    from PIL import ImageFont

    for path in _FONT_CANDIDATES:
        try:
            return ImageFont.truetype(path, size)
        except OSError:
            continue
    return ImageFont.load_default()


def to_uint8_rgb(img: np.ndarray) -> np.ndarray:
    """HWC float -> uint8 with the reference's truncating cast
    (vae_utility.py:387): negatives wrap, as in the reference's numpy."""
    with np.errstate(invalid="ignore", over="ignore"):
        return (np.asarray(img) * 255).astype(np.uint8)


def _as_pil(img: np.ndarray):
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8_rgb(arr)
    if arr.ndim == 2:
        return Image.fromarray(arr, mode="L").convert("RGB")
    return Image.fromarray(arr, mode="RGB")


def final_frame(orig: np.ndarray, recon_one: np.ndarray, recon_zero: np.ndarray,
                diff_u8: np.ndarray, pred: float, *, gt: Optional[np.ndarray] = None,
                thr_mask: Optional[np.ndarray] = None, crf_mask: Optional[np.ndarray] = None,
                thr_iou: Optional[float] = None, crf_iou: Optional[float] = None,
                threshold: int = 50):
    """One annotated strip (reference: get_final_frame). Image arguments are
    HWC: floats in [0, 1] or uint8 for RGB panels, uint8/bool 2-D for masks.
    With masks: 6 panels (7 with ``gt``), double height, a row of titles."""
    from PIL import Image, ImageDraw

    w = orig.shape[1]
    with_masks = thr_mask is not None
    n_panels = 4 + (3 if with_masks and gt is not None else 2 if with_masks else 0)
    ih = w if with_masks else 0
    canvas = Image.new("RGB", (w * n_panels, w * 2 if with_masks else w))
    draw = ImageDraw.Draw(canvas)

    canvas.paste(_as_pil(orig), (0, ih))
    canvas.paste(_as_pil(recon_one), (w, ih))
    canvas.paste(_as_pil(recon_zero), (w * 2, ih))
    canvas.paste(_as_pil(diff_u8), (w * 3, ih))
    if with_masks:
        if crf_mask is None:  # threshold-only rendering: an empty CRF panel
            crf_mask = np.zeros_like(np.asarray(thr_mask))
        canvas.paste(_as_pil(np.asarray(thr_mask, np.uint8) * 255), (w * 4, ih))
        canvas.paste(_as_pil(np.asarray(crf_mask, np.uint8) * 255), (w * 5, ih))
        if gt is not None:
            canvas.paste(_as_pil(np.asarray(gt, np.uint8) * 255), (w * 6, ih))
        for i, title in enumerate(TITLES[:n_panels]):
            text = title.format(thr=threshold)
            if i == 4 and thr_iou is not None:
                text += f"\niou={thr_iou}"
            elif i == 5 and crf_iou is not None:
                text += f"\niou={crf_iou}"
            draw.text((w * i + 2, 0), text, (255, 255, 255), font=font())
    draw.text((2, ih + 2), f"{float(pred):.1f}", (255, 255, 255), font=font())
    return canvas


def inject_strip(orig: np.ndarray, recons: Sequence[np.ndarray]):
    """The original beside its K injected reconstructions, HWC each
    (reference: get_injected_img, vae_utility.py:240-254)."""
    from PIL import Image

    panels = [_as_pil(orig)] + [_as_pil(r) for r in recons]
    w, h = panels[0].size
    strip = Image.new("RGB", (w * len(panels), h))
    for i, p in enumerate(panels):
        strip.paste(p, (w * i, 0))
    return strip
