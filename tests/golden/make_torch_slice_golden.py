"""Write tests/golden/torch_slice_golden.npz, torch_sweep_golden.npz,
torch_slice_golden_bf16.npz and torch_saliency_golden.npz: the JAX
package's mask-video slice, threshold sweep, bf16 runs and ``--quality``
chain with its CRF search on the CPU, the
references the PyTorch port is held against (by tests/test_torch_slice.py
and tests/test_torch_sweep.py on the CPU and by chip_smoke.py on the card).

Configuration: 16 synthetic 64x64 frames (``generate_frames(16, seed=0)``),
the full-width critic ``saved-networks/critic-synthetic.npz`` and VAE
``numpy_vae_params(0)``, float32, threshold 50, and the device CRF with the
Pallas build (``build="pallas"``, float32, in interpret mode on the CPU) at
``REFERENCE_CRF_PARAMS``. The steps are those of ``eval_episode``: the
device stage, the mean of the per-frame maxima, normalisation, threshold,
CRF, whole-stack IoU.

The sweep file holds the same device stage swept over the reference's 13
thresholds (0..120 step 10): each threshold's whole-stack IoU, and the IoU
of the T = 13 mask sets refined together by ``refine_masks_multi_device``
(Pallas build, float32, interpret mode). It also holds the masks of the
``int8`` and ``vmem`` builds (Pallas kernels in interpret mode) refining the
threshold-50 masks of the first 4 frames.

The bf16 file holds the same episode, and a second one (frames and VAE of
seed 1), through the JAX ``eval_episode`` in bfloat16
(``compute_dtype="bfloat16"``, the device CRF at its CPU default, the
float32 ``xla`` build): per seed, preds, uint8 maps, threshold and CRF
masks and both IoUs, which chip_smoke.py holds the card's bf16 runs
against.

The saliency file holds the ``--quality`` chain (LayerCAM at block 1,
lanczos3, {id, mirror} x {0, +-2 px} TTA, threshold 64, the CAM-tuned CRF
132,32,3.1,8,1.8,10) on 64 synthetic frames (``generate_frames(64,
seed=21)``) through the JAX ``eval_episode`` in float32: preds, uint8 maps,
threshold masks, the CRF masks of the Pallas build in float32 (interpret
mode), both IoUs; and ``crf_param_search`` on a 2x2 grid (w1 in {22, 132},
alpha in {12, 32}) over those threshold masks: the scores and parameters in
its order and each combination's masks (its CPU build, ``xla`` in float32).
chip_smoke.py holds the card's ``--quality`` chain and search against it.

The train file holds 3 steps of the JAX package's train step
(``make_train_step``, float32, at full width) from ``numpy_vae_params(0)``
on one batch of 16 synthetic uint8 frames (``generate_frames(16,
seed=0)``), Adam lr 5e-5 behind ``apply_if_finite``, the critic of
``critic-synthetic.npz``: the reparametrize noise each step drew (replayed
from the state's key with public ``jax.random`` calls: split, then normal
(16, 32) float32), each step's total, recon and kld losses, the BatchNorm
running stats after the first step and after the 3 steps, the first step's
train-mode ``mu`` and ``logvar`` (``encode`` from the initial parameters),
and each parameter leaf's change over the 3 steps at 64 seeded positions
(JAX layout). chip_smoke.py and
tests/test_torch_train.py hold the port's train step against it.

The distill file (torch_distill_golden.npz) holds the JAX package's
``build_pseudo_masks`` on 32 synthetic frames (``generate_frames(32,
seed=30)``) with the synthetic critic: the thresholded LayerCAM masks
(``run_crf=False``) and the CRF masks of its ``device`` backend on the CPU
(the float32 ``xla`` build, 16 frames a chunk), and 3 train steps with
``mask_distill=0.5`` at full width from ``numpy_vae_params(0)`` on 16 of
the frames with their CRF masks, in the train file's layout (noise, losses
with ``md_loss``, BN stats, parameter changes at 64 seeded positions). The
16 (``step_rows``) are the first frames the critic scores at least 0.05: at
a value near 0 the two decodes differ by ~v, the term divides their
difference by its max (~1e-4 there) and its gradient changes by up to 10%
when float32 noise of 5e-6 in mu moves a decoder ReLU across 0 in one decode
and not the other (the JAX package's own float64 gradient at the port's mu
shows it), so no two float32 implementations meet the train bars there.
chip_smoke.py holds the card's masks and steps against it.

The critic file (torch_critic_golden.npz) holds 3 steps of the JAX
package's critic training step (``make_critic_multi_step``, dropout 0.3,
``optax.adam(1e-3)``) from ``numpy_critic_params(0)`` on 128 synthetic
frames (``generate_frames(128, seed=40)``) with soft trunk labels: the
dropout masks each step drew (replayed with public ``jax.random`` calls:
split the state's key, split the step's key in 3, bernoulli of each layer's
NHWC shape), each step's loss and the params after the 3 steps; and
``critic_cam_health`` of the synthetic critic on ``generate_frames(128,
seed=9999)``. chip_smoke.py holds the card's critic training against it.

Run from the repo root:
  JAX_PLATFORMS=cpu python tests/golden/make_torch_slice_golden.py [slice|sweep|bf16|saliency|train|distill|critic|all]
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
from critic_vae_tpu.crf.device import (  # noqa: E402
    crf_param_search,
    refine_masks_device,
    refine_masks_multi_device,
)
from critic_vae_tpu.data.synthetic import generate_frames  # noqa: E402
from critic_vae_tpu.models.critic import load_critic  # noqa: E402
from critic_vae_tpu.ops.iou import iou  # noqa: E402
from critic_vae_tpu.pipelines.video import eval_episode  # noqa: E402
from critic_vae_tpu.ops.mask import (  # noqa: E402
    episode_forward,
    normalize_diffs_given_mean,
    threshold_masks,
)
from critic_vae_tpu_torch.io.weights import numpy_critic_params, numpy_vae_params  # noqa: E402

NUM_FRAMES = 16
SEED = 0
THRESHOLD = 50
OUT = os.path.join(ROOT, "tests", "golden", "torch_slice_golden.npz")
SWEEP_OUT = os.path.join(ROOT, "tests", "golden", "torch_sweep_golden.npz")
BF16_OUT = os.path.join(ROOT, "tests", "golden", "torch_slice_golden_bf16.npz")
SWEEP = tuple(range(0, 130, 10))
BF16_SEEDS = (0, 1)  # each the seed of the frames and of numpy_vae_params
BUILD_FRAMES = 4  # frames refined by the int8 and vmem builds
SALIENCY_OUT = os.path.join(ROOT, "tests", "golden", "torch_saliency_golden.npz")
SALIENCY_FRAMES = 64
SALIENCY_SEED = 21
# the --quality preset of the JAX package's cli.py
QUALITY_OPTS = {"method": "layercam", "tta_flip": True, "tta_shift": 2}
QUALITY_CRF = (132.0, 32.0, 3.1, 8.0, 1.8, 10)
QUALITY_THRESHOLD = 64
SEARCH_GRID = {"w1": [22.0, 132.0], "alpha": [12.0, 32.0]}
TRAIN_OUT = os.path.join(ROOT, "tests", "golden", "torch_train_golden.npz")
TRAIN_STEPS = 3
TRAIN_BATCH = 16
TRAIN_LR = 5e-5
TRAIN_SAMPLES = 64  # sampled positions of each parameter leaf's change
DISTILL_OUT = os.path.join(ROOT, "tests", "golden", "torch_distill_golden.npz")
DISTILL_FRAMES = 32
DISTILL_SEED = 30
DISTILL_WEIGHT = 0.5
DISTILL_CRF_MEM = 1 << 30  # the JAX CRF's workspace cap: 16 frames a chunk at 64x64
DISTILL_STEP_MIN_PRED = 0.05  # the step batch's frames: critic score at least this
CRITIC_OUT = os.path.join(ROOT, "tests", "golden", "torch_critic_golden.npz")
CRITIC_FRAMES = 128
CRITIC_SEED = 40
CRITIC_LR = 1e-3
CRITIC_DROPOUT = 0.3
HEALTH_FRAMES = 128
HEALTH_SEED = 9999


def device_stage():
    """(frames, gt, preds, max_value, mean_max, diff_u8) of the golden episode."""
    frames, gt = generate_frames(NUM_FRAMES, seed=SEED)
    critic = load_critic(os.path.join(ROOT, "saved-networks", "critic-synthetic.npz"))
    vae_params, bn_state = numpy_vae_params(SEED)
    out = episode_forward(vae_params, bn_state, critic, jnp.asarray(frames),
                          with_recons=False, compute_dtype="float32")
    max_value = np.asarray(out["max_value"])
    mean_max = np.asarray(jnp.mean(jnp.asarray(max_value)))
    diff_u8 = normalize_diffs_given_mean(out["diff"], mean_max)
    return frames, gt, out["preds"], max_value, mean_max, diff_u8


def sweep() -> None:
    frames, gt, _, _, _, diff_u8 = device_stage()
    masks = np.asarray(threshold_masks(diff_u8, jnp.asarray(SWEEP)))  # (T, N, H, W)
    refined = refine_masks_multi_device(frames, masks, REFERENCE_CRF_PARAMS, build="pallas",
                                        compute_dtype="float32", frame_chunk=4)
    thr_iou = [iou(gt, m) for m in masks]
    crf_iou = [iou(gt, m) for m in refined]
    thr50 = masks[SWEEP.index(THRESHOLD), :BUILD_FRAMES]
    builds = {
        f"{b}_bits": np.packbits(refine_masks_device(frames[:BUILD_FRAMES], thr50,
                                                     REFERENCE_CRF_PARAMS, build=b), axis=-1)
        for b in ("int8", "vmem")
    }
    np.savez_compressed(
        SWEEP_OUT,
        thresholds=np.asarray(SWEEP, np.int64),
        thr_iou=np.asarray(thr_iou, np.float64),
        crf_iou=np.asarray(crf_iou, np.float64),
        num_frames=np.int64(NUM_FRAMES),
        seed=np.int64(SEED),
        build_frames=np.int64(BUILD_FRAMES),
        build_threshold=np.int64(THRESHOLD),
        **builds,
    )
    print(f"wrote {SWEEP_OUT} ({os.path.getsize(SWEEP_OUT)} bytes): thr_iou={thr_iou} "
          f"crf_iou={crf_iou}")


def bf16() -> None:
    critic = load_critic(os.path.join(ROOT, "saved-networks", "critic-synthetic.npz"))
    runs = []
    for seed in BF16_SEEDS:
        frames, gt = generate_frames(NUM_FRAMES, seed=seed)
        vae_params, bn_state = numpy_vae_params(seed)
        runs.append(eval_episode(vae_params, bn_state, critic, frames, gt, threshold=THRESHOLD,
                                 crf_backend="device", with_recons=False,
                                 compute_dtype="bfloat16"))
    np.savez_compressed(
        BF16_OUT,
        preds=np.stack([np.asarray(r.preds, np.float32) for r in runs]),
        diff_u8=np.stack([np.asarray(r.diff_u8, np.uint8) for r in runs]),
        thr_bits=np.stack([np.packbits(r.thr_masks, axis=-1) for r in runs]),
        crf_bits=np.stack([np.packbits(r.crf_masks, axis=-1) for r in runs]),
        thr_iou=np.asarray([r.thr_iou for r in runs], np.float64),
        crf_iou=np.asarray([r.crf_iou for r in runs], np.float64),
        num_frames=np.int64(NUM_FRAMES),
        seeds=np.asarray(BF16_SEEDS, np.int64),
        threshold=np.int64(THRESHOLD),
    )
    print(f"wrote {BF16_OUT} ({os.path.getsize(BF16_OUT)} bytes): seeds {BF16_SEEDS} thr_iou="
          f"{[r.thr_iou for r in runs]} crf_iou={[r.crf_iou for r in runs]}")


def saliency() -> None:
    frames, gt = generate_frames(SALIENCY_FRAMES, seed=SALIENCY_SEED)
    critic = load_critic(os.path.join(ROOT, "saved-networks", "critic-synthetic.npz"))
    vae_params, bn_state = numpy_vae_params(0)
    res = eval_episode(vae_params, bn_state, critic, frames, gt, threshold=QUALITY_THRESHOLD,
                       run_crf=False, with_recons=False, batch_size=SALIENCY_FRAMES,
                       mask_source="saliency", saliency_opts=QUALITY_OPTS)
    crf = refine_masks_device(frames, res.thr_masks, QUALITY_CRF, build="pallas",
                              compute_dtype="float32", frame_chunk=4)
    _, results = crf_param_search(frames, res.thr_masks, gt, SEARCH_GRID, frame_chunk=4)
    search_bits = [np.packbits(refine_masks_device(frames, res.thr_masks, p, frame_chunk=4),
                               axis=-1) for _, p in results]
    np.savez_compressed(
        SALIENCY_OUT,
        preds=np.asarray(res.preds, np.float32),
        diff_u8=np.asarray(res.diff_u8, np.uint8),
        thr_bits=np.packbits(res.thr_masks, axis=-1),
        crf_bits=np.packbits(crf, axis=-1),
        thr_iou=np.float64(res.thr_iou),
        crf_iou=np.float64(iou(gt, crf)),
        search_scores=np.asarray([r[0] for r in results], np.float64),
        search_params=np.asarray([r[1] for r in results], np.float64),
        search_bits=np.stack(search_bits),
        num_frames=np.int64(SALIENCY_FRAMES),
        seed=np.int64(SALIENCY_SEED),
        threshold=np.int64(QUALITY_THRESHOLD),
        crf_params=np.asarray(QUALITY_CRF, np.float64),
    )
    print(f"wrote {SALIENCY_OUT} ({os.path.getsize(SALIENCY_OUT)} bytes): thr_iou="
          f"{res.thr_iou} crf_iou={iou(gt, crf)} search={results}")


def train() -> None:
    from critic_vae_tpu.models.vae import encode

    frames, _ = generate_frames(TRAIN_BATCH, seed=SEED)
    params, bn_state = numpy_vae_params(SEED)
    x = jnp.asarray(frames).astype(jnp.float32) / jnp.asarray(255.0, jnp.float32)
    mu1, logvar1, _ = jax.jit(lambda p, s, xx: encode(p, s, xx, train=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, bn_state), x)
    out = _train_steps(frames, None, 0.0)
    np.savez_compressed(TRAIN_OUT, mu1=np.asarray(mu1, np.float32),
                        logvar1=np.asarray(logvar1, np.float32), **out)
    print(f"wrote {TRAIN_OUT} ({os.path.getsize(TRAIN_OUT)} bytes): losses="
          f"{ {k: out[k].tolist() for k in ('total_loss', 'recon_loss', 'kld')} }")


def _train_steps(frames, masks, mask_distill: float) -> dict:
    """3 JAX train steps at full width from numpy_vae_params(SEED) on one
    batch: noise, losses, BN stats after step 1 and 3, parameter changes at
    TRAIN_SAMPLES seeded positions a leaf (the train file's layout)."""
    import optax

    from critic_vae_tpu.train.step import TrainState, make_train_step

    critic = load_critic(os.path.join(ROOT, "saved-networks", "critic-synthetic.npz"))
    params, bn_state = numpy_vae_params(SEED)
    tx = optax.apply_if_finite(optax.adam(TRAIN_LR, b1=0.9, b2=0.999, eps=1e-8),
                               max_consecutive_errors=100)
    p0 = jax.tree.map(jnp.asarray, params)
    key = jax.random.key(SEED)
    state = TrainState(p0, jax.tree.map(jnp.asarray, bn_state), tx.init(p0), key,
                       jnp.zeros((), jnp.int32))
    step = make_train_step(critic, tx, compute_dtype=jnp.float32, donate=False,
                           mask_distill=mask_distill)
    extra = (jnp.asarray(masks),) if mask_distill > 0.0 else ()
    out, eps, losses = {}, [], {}
    for t in range(TRAIN_STEPS):
        key, sample_key = jax.random.split(key)  # as the step splits state.rng
        eps.append(np.asarray(jax.random.normal(sample_key, (len(frames), 32), jnp.float32)))
        state, metrics = step(state, jnp.asarray(frames), *extra)
        for k, v in metrics.items():
            losses.setdefault(k, []).append(float(v))
        if t == 0:
            for i in range(4):
                for k in ("mean", "var"):
                    out[f"bn{i}_{k}_1"] = np.asarray(state.bn_state[f"bn{i}"][k], np.float32)
    rng = np.random.default_rng(SEED)
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
        name = "/".join(k.key for k in path)
        delta = (np.asarray(leaf) - _leaf(params, name)).ravel()
        index = np.sort(rng.choice(delta.size, min(TRAIN_SAMPLES, delta.size), replace=False))
        out[f"index/{name}"] = index.astype(np.int64)
        out[f"delta/{name}"] = delta[index].astype(np.float32)
    for i in range(4):
        for k in ("mean", "var"):
            out[f"bn{i}_{k}"] = np.asarray(state.bn_state[f"bn{i}"][k], np.float32)
    return dict(eps=np.stack(eps), **{k: np.asarray(v, np.float32) for k, v in losses.items()},
                lr=np.float32(TRAIN_LR), steps=np.int64(TRAIN_STEPS),
                batch=np.int64(len(frames)), seed=np.int64(SEED), **out)


def distill() -> None:
    from critic_vae_tpu.pipelines.distill import CAM_TUNED_CRF_PARAMS, build_pseudo_masks

    os.environ["CRITIC_VAE_TPU_CRF_MEM"] = str(DISTILL_CRF_MEM)
    frames, _ = generate_frames(DISTILL_FRAMES, seed=DISTILL_SEED)
    critic = load_critic(os.path.join(ROOT, "saved-networks", "critic-synthetic.npz"))
    thr = build_pseudo_masks(critic, frames, run_crf=False, batch_size=DISTILL_FRAMES)
    crf = build_pseudo_masks(critic, frames, crf_backend="device", batch_size=DISTILL_FRAMES)
    from critic_vae_tpu.models.critic import critic_apply

    preds = np.asarray(critic_apply(critic, jnp.asarray(frames, jnp.float32) / 255.0))[:, 0]
    rows = np.flatnonzero(preds >= DISTILL_STEP_MIN_PRED)[:TRAIN_BATCH]
    steps = _train_steps(frames[rows], crf[rows], DISTILL_WEIGHT)
    np.savez_compressed(
        DISTILL_OUT, thr_bits=np.packbits(thr, axis=-1), crf_bits=np.packbits(crf, axis=-1),
        step_rows=rows.astype(np.int64), step_min_pred=np.float32(DISTILL_STEP_MIN_PRED),
        num_frames=np.int64(DISTILL_FRAMES), frames_seed=np.int64(DISTILL_SEED),
        crf_params=np.asarray(CAM_TUNED_CRF_PARAMS, np.float64),
        mask_distill=np.float32(DISTILL_WEIGHT), **steps)
    print(f"wrote {DISTILL_OUT} ({os.path.getsize(DISTILL_OUT)} bytes): thr mask pixels "
          f"{int(thr.sum())}, crf {int(crf.sum())}, losses "
          f"{ {k: steps[k].tolist() for k in ('total_loss', 'md_loss')} }")


def critic_masks(key, steps: int, batch: int, keep: float):
    """The dropout keep masks the JAX critic step draws from a state's key,
    NHWC: per step (block 2's pool, block 3's pool, fc0)."""
    out = []
    for _ in range(steps):
        key, drop_key = jax.random.split(key)
        ks = jax.random.split(drop_key, 3)
        out.append([np.asarray(jax.random.bernoulli(k, keep, shape))
                    for k, shape in zip(ks, ((batch, 8, 8, 8), (batch, 4, 4, 16), (batch, 32)))])
    return out


def critic() -> None:
    import optax

    from critic_vae_tpu.train.critic import (critic_cam_health, make_critic_multi_step,
                                             soft_trunk_labels)

    frames, gt = generate_frames(CRITIC_FRAMES, seed=CRITIC_SEED)
    labels = soft_trunk_labels(gt)
    params = jax.tree.map(jnp.asarray, numpy_critic_params(0))
    tx = optax.adam(CRITIC_LR)
    key = jax.random.key(1)
    multi = make_critic_multi_step(tx, dropout_rate=CRITIC_DROPOUT, donate=False)
    idx = np.arange(CRITIC_FRAMES, dtype=np.int32)[None].repeat(TRAIN_STEPS, 0)
    (new, _, _), losses = multi((params, tx.init(params), key), jnp.asarray(frames),
                                jnp.asarray(labels), jnp.asarray(idx))
    masks = critic_masks(key, TRAIN_STEPS, CRITIC_FRAMES, 1.0 - CRITIC_DROPOUT)
    health = critic_cam_health(
        load_critic(os.path.join(ROOT, "saved-networks", "critic-synthetic.npz")),
        generate_frames(HEALTH_FRAMES, seed=HEALTH_SEED)[0])
    np.savez_compressed(
        CRITIC_OUT, losses=np.asarray(losses, np.float32), labels=labels,
        **{f"mask{t}_{j}": np.packbits(m, axis=-1) for t, ms in enumerate(masks)
           for j, m in enumerate(ms)},
        **{f"params/{k}": np.asarray(v) for k, v in new.items()},
        **{f"health/{k}": np.float64(v) for k, v in health.items()},
        lr=np.float32(CRITIC_LR), dropout=np.float32(CRITIC_DROPOUT),
        steps=np.int64(TRAIN_STEPS), num_frames=np.int64(CRITIC_FRAMES),
        frames_seed=np.int64(CRITIC_SEED), health_frames=np.int64(HEALTH_FRAMES),
        health_seed=np.int64(HEALTH_SEED))
    print(f"wrote {CRITIC_OUT} ({os.path.getsize(CRITIC_OUT)} bytes): losses "
          f"{np.asarray(losses).tolist()} health {health}")


def _leaf(tree, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def main() -> None:
    frames, gt, preds, max_value, mean_max, diff_u8 = device_stage()
    thr = np.asarray(threshold_masks(diff_u8, jnp.asarray([THRESHOLD]))[0])
    crf = refine_masks_device(frames, thr, REFERENCE_CRF_PARAMS, build="pallas",
                              compute_dtype="float32", frame_chunk=4)
    thr_iou, crf_iou = iou(gt, thr), iou(gt, crf)
    np.savez_compressed(
        OUT,
        preds=np.asarray(preds, np.float32),
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
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    if what not in ("slice", "sweep", "bf16", "saliency", "train", "distill", "critic", "all"):
        raise SystemExit(
            f"usage: {sys.argv[0]} [slice|sweep|bf16|saliency|train|distill|critic|all]")
    if what in ("slice", "all"):
        main()
    if what in ("sweep", "all"):
        sweep()
    if what in ("bf16", "all"):
        bf16()
    if what in ("saliency", "all"):
        saliency()
    if what in ("train", "all"):
        train()
    if what in ("distill", "all"):
        distill()
    if what in ("critic", "all"):
        critic()
