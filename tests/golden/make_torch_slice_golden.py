"""Write tests/golden/torch_slice_golden.npz: the JAX package's mask-video
slice on the CPU, the reference the PyTorch port is held against (by
tests/test_torch_slice.py on the CPU and by chip_smoke.py on the card).

Configuration: 16 synthetic 64x64 frames (``generate_frames(16, seed=0)``),
the full-width critic ``saved-networks/critic-synthetic.npz`` and VAE
``numpy_vae_params(0)``, float32, threshold 50, and the device CRF with the
Pallas build (``build="pallas"``, float32, in interpret mode on the CPU) at
``REFERENCE_CRF_PARAMS``. The steps are those of ``eval_episode``: the
device stage, the mean of the per-frame maxima, normalisation, threshold,
CRF, whole-stack IoU.

Run from the repo root:  JAX_PLATFORMS=cpu python tests/golden/make_torch_slice_golden.py
"""

from __future__ import annotations

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from critic_vae_tpu.crf import REFERENCE_CRF_PARAMS  # noqa: E402
from critic_vae_tpu.crf.device import refine_masks_device  # noqa: E402
from critic_vae_tpu.data.synthetic import generate_frames  # noqa: E402
from critic_vae_tpu.models.critic import load_critic  # noqa: E402
from critic_vae_tpu.ops.iou import iou  # noqa: E402
from critic_vae_tpu.ops.mask import (  # noqa: E402
    episode_forward,
    normalize_diffs_given_mean,
    threshold_masks,
)
from critic_vae_tpu_torch.io.weights import numpy_vae_params  # noqa: E402

NUM_FRAMES = 16
SEED = 0
THRESHOLD = 50
OUT = os.path.join(ROOT, "tests", "golden", "torch_slice_golden.npz")


def main() -> None:
    frames, gt = generate_frames(NUM_FRAMES, seed=SEED)
    critic = load_critic(os.path.join(ROOT, "saved-networks", "critic-synthetic.npz"))
    vae_params, bn_state = numpy_vae_params(SEED)
    out = episode_forward(vae_params, bn_state, critic, jnp.asarray(frames),
                          with_recons=False, compute_dtype="float32")
    max_value = np.asarray(out["max_value"])
    mean_max = np.asarray(jnp.mean(jnp.asarray(max_value)))
    diff_u8 = normalize_diffs_given_mean(out["diff"], mean_max)
    thr = np.asarray(threshold_masks(diff_u8, jnp.asarray([THRESHOLD]))[0])
    crf = refine_masks_device(frames, thr, REFERENCE_CRF_PARAMS, build="pallas",
                              compute_dtype="float32", frame_chunk=4)
    thr_iou, crf_iou = iou(gt, thr), iou(gt, crf)
    np.savez_compressed(
        OUT,
        preds=np.asarray(out["preds"], np.float32),
        max_value=max_value.astype(np.float32),
        mean_max=np.float32(mean_max),
        diff_u8=np.asarray(diff_u8, np.uint8),
        thr_bits=np.packbits(thr, axis=-1),
        crf_bits=np.packbits(crf, axis=-1),
        thr_iou=np.float64(thr_iou),
        crf_iou=np.float64(crf_iou),
        num_frames=np.int64(NUM_FRAMES),
        seed=np.int64(SEED),
        threshold=np.int64(THRESHOLD),
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): thr_iou={thr_iou} crf_iou={crf_iou}")


if __name__ == "__main__":
    main()
