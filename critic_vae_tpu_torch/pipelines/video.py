"""Video / mask-evaluation pipeline (counterpart of
critic_vae_tpu/pipelines/video.py).

Per frame: critic score, encode, double decode, diff/grey/max (kernel B1),
or with ``mask_source="saliency"`` the critic's saliency maps instead,
then the global mean-max normalisation to uint8, the threshold, the dense
CRF and whole-stack IoU. The CRF is the exact device mean field (kernel B2,
or the ``xla``/``int8``/``vmem`` builds) or the host C++ lattice, as
crf/policy.py resolves it. ``eval_episode`` keeps everything up to the masks
on the device and scores on the host; with the host CRF a worker thread
refines each chunk's masks as they reach the host. ``threshold_sweep`` runs
the device stage once and scores every threshold on the device (the host
CRF refines per threshold). With ``mesh=`` (parallel/mesh.py) each rank
runs the device stage and the device CRF on its rows of every chunk and
the rows are gathered, so every rank holds the whole result, as the JAX
package's meshed runs. ``bin_diagnostics``/``write_bin_info`` write the
reference's bin_info file, ``compose_frames`` the annotated strips of the
GIF (Pillow, imported only there). Under a profiler each ``eval_episode``
is a ``video.episode`` span holding its stages' spans (upload, device
stage, normalise and threshold, CRF, read-backs, scoring;
utils/profiling.py::span).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE
from critic_vae_tpu_torch.ops.iou import iou, iou_batch
from critic_vae_tpu_torch.ops.mask import (
    episode_forward,
    normalize_diffs_given_mean,
    threshold_masks,
)
from critic_vae_tpu_torch.utils.profiling import span

# the reference's -thresh sweep (vae.py:121-123): 0..120 step 10
DEFAULT_SWEEP = tuple(range(0, 130, 10))


def _normalize_threshold_chunk(diff: torch.Tensor, mean_max: torch.Tensor,
                               thresholds: torch.Tensor):
    """One chunk's mean-max normalisation to uint8 and its (T, B, H, W)
    masks for all thresholds at once."""
    u8 = normalize_diffs_given_mean(diff, mean_max)
    return u8, threshold_masks(u8, thresholds)


def _sweep_chunk_stats(masks: torch.Tensor, gt: torch.Tensor):
    """(tp, fn, fp) int64 counts per threshold of (T, B, H, W) masks
    against (B, H, W) ground truth, on the masks' device."""
    g = gt[None].bool()
    m = masks.bool()
    return (torch.sum(g & m, dim=(1, 2, 3)), torch.sum(g & ~m, dim=(1, 2, 3)),
            torch.sum(~g & m, dim=(1, 2, 3)))


def _refine(frames_u8, thr_masks, crf_params, backend: str, num_threads: int = 0,
            mesh=None):
    """CRF refinement on ``backend``: ``device`` (the exact mean field of
    crf/device.py, on the masks' device, over ``mesh`` when given) or
    ``host`` (the C++ lattice on numpy arrays)."""
    if backend == "device":
        from critic_vae_tpu_torch.crf.device import refine_masks_device

        return refine_masks_device(frames_u8, thr_masks, crf_params, fetch=False, mesh=mesh)
    if backend != "host":
        raise ValueError(f"unknown crf backend {backend!r} (host|device)")
    from critic_vae_tpu_torch.crf.host import refine_masks

    return refine_masks(frames_u8, thr_masks, crf_params, num_threads)


@dataclasses.dataclass
class EpisodeResult:
    preds: np.ndarray                 # (N,)
    recon_one: Optional[np.ndarray]   # (N, H, W, 3) float32 or uint8; None without recons
    recon_zero: Optional[np.ndarray]
    diff_u8: np.ndarray               # (N, H, W) uint8 normalized diff maps
    thr_masks: np.ndarray             # (N, H, W) bool
    crf_masks: Optional[np.ndarray]   # (N, H, W) bool, or None without CRF
    thr_iou: Optional[float]
    crf_iou: Optional[float]


# the JAX package's saliency_opts keys and defaults (its pipelines/video.py)
SALIENCY_DEFAULTS = dict(logits=False, samples=1, noise=0.0, seed=0, sigma=None,
                         method="gradient", cam_block=1, cam_upsample="lanczos3",
                         tta_flip=False, tta_shift=0)


def episode_device_stage(vae: Optional[VAE], critic: Critic, frames_u8: torch.Tensor,
                         batch_size: int = 512, *, compute_dtype: str = "float32",
                         with_recons: bool = False, recons_u8: bool = False,
                         mask_source: str = "diff", saliency_opts: Optional[Dict] = None,
                         mesh=None):
    """Run :func:`episode_forward` over device-resident uint8 frames (N, H,
    W, 3) in chunks of ``batch_size``, the last padded by repeating its last
    frame, so every chunk has one shape. ``vae`` may be None for the
    saliency source without ``with_recons``, which never decodes.

    ``saliency_opts`` (read for ``mask_source="saliency"``) holds any of the
    JAX package's keys ``logits``, ``samples``, ``noise``, ``seed``,
    ``sigma``, ``method``, ``cam_block``, ``cam_upsample``, ``tta_flip``,
    ``tta_shift`` (ops/saliency.py::critic_saliency's options); another key
    raises. With SmoothGrad on (``noise > 0``) chunk k draws its noise from
    its own generator, seeded ``seed + k``.

    With a ``mesh`` (parallel/mesh.py) ``batch_size`` is rounded up to a
    multiple of its ranks, as in the JAX package, each rank runs its rows of
    every padded chunk (drawing the whole chunk's SmoothGrad noise and taking
    its rows', so each frame gets the noise of the one-process run at that
    batch size), and the chunk's outputs are gathered so that every rank
    holds them whole (parallel/mesh.py::fetch); the frames must be the same
    on every rank.

    Returns (preds (N,), max_value (N,), diff_chunks, valids, recons): the
    trimmed per-frame outputs, the per-chunk diff maps as they came (still
    padded), each chunk's count of valid frames, all on the device, and with
    ``with_recons`` the trimmed (recon_one, recon_zero) on the host (else
    None)."""
    sal = dict(SALIENCY_DEFAULTS)
    if saliency_opts:
        unknown = set(saliency_opts) - set(sal)
        if unknown:
            raise ValueError(f"unknown saliency_opts keys: {sorted(unknown)}")
        sal.update(saliency_opts)
    # noise == 0 is the deterministic path whatever the sample count
    sampling = mask_source == "saliency" and sal["noise"] > 0.0
    if mesh is not None:
        batch_size = max(batch_size, mesh.size)
        batch_size += (-batch_size) % mesh.size
    keys = ("preds", "max_value", "diff") + (("recon_one", "recon_zero") if with_recons else ())
    n = frames_u8.shape[0]
    preds, maxes, diff_chunks, valids = [], [], [], []
    recons = ([], []) if with_recons else None
    for i in range(0, n, batch_size):
        chunk = frames_u8[i : i + batch_size]
        valid = chunk.shape[0]
        if valid < batch_size:
            pad = chunk[-1:].expand(batch_size - valid, -1, -1, -1)
            chunk = torch.cat([chunk, pad])
        rows = None
        if mesh is not None:
            from critic_vae_tpu_torch.parallel.mesh import row_offset, shard_batch

            rows = (row_offset(mesh, batch_size), batch_size)
            chunk = shard_batch(mesh, chunk)
        out = episode_forward(
            vae, critic, chunk, compute_dtype=compute_dtype, with_recons=with_recons,
            recons_u8=recons_u8, mask_source=mask_source, saliency_logits=sal["logits"],
            saliency_samples=sal["samples"], saliency_noise=sal["noise"],
            saliency_sigma=sal["sigma"], saliency_method=sal["method"],
            saliency_cam_block=sal["cam_block"], saliency_cam_upsample=sal["cam_upsample"],
            saliency_tta_flip=sal["tta_flip"], saliency_tta_shift=sal["tta_shift"],
            saliency_seed=sal["seed"] + i // batch_size if sampling else None,
            saliency_rows=rows if sampling else None)
        if mesh is not None:
            from critic_vae_tpu_torch.parallel.mesh import fetch

            out = {k: fetch(mesh, out[k]) for k in keys}
        preds.append(out["preds"][:valid])
        maxes.append(out["max_value"][:valid])
        diff_chunks.append(out["diff"])
        valids.append(valid)
        if with_recons:
            for part, key in zip(recons, ("recon_one", "recon_zero")):
                part.append(out[key][:valid].cpu().numpy())
    if with_recons:
        recons = tuple(np.concatenate(part) for part in recons)
    return torch.cat(preds), torch.cat(maxes), diff_chunks, valids, recons


def eval_episode(vae: VAE, critic: Critic, frames_u8: np.ndarray,
                 gt: Optional[np.ndarray], *, device: torch.device,
                 threshold: int = 50, crf_params: Tuple = REFERENCE_CRF_PARAMS,
                 run_crf: bool = True, batch_size: int = 512, num_threads: int = 0,
                 compute_dtype: str = "float32", crf_backend: str = "auto",
                 recons_u8: bool = False, with_recons: bool = False,
                 mask_source: str = "diff", saliency_opts: Optional[Dict] = None,
                 mesh=None) -> EpisodeResult:
    """The mask pipeline over an episode (reference: eval_textured_frames).

    Args:
      frames_u8: (N, H, W, 3) uint8 raw frames; they go to ``device`` once
        and feed both the nets (normalised there) and the CRF (raw).
      gt: (N, H, W) bool ground truth, or None to skip IoU scoring.
      crf_backend: "auto", "device" or "host" (crf/policy.py). The device
        CRF's build is ``auto`` unless ``CRITIC_VAE_TPU_CRF_BUILD`` names
        another (crf/device.py::_resolve_build), as in the JAX package. The
        host CRF refines each chunk on one worker thread as its masks reach
        the host, ``num_threads`` OpenMP threads (0: OpenMP's default).
      with_recons: also return the reconstructions (the panels' input), as
        uint8 with ``recons_u8``. Off by default, so the mask path computes
        nothing more (the JAX package's default is on; its ``video`` and
        this port's pass it explicitly, on exactly when a GIF is drawn).
      mask_source: "diff" (the reference's) or "saliency" (the critic's
        saliency maps through the same normalisation, threshold and CRF;
        ``diff_u8`` then holds the normalised saliency maps), with
        ``saliency_opts`` as in :func:`episode_device_stage`.
      mesh: a data-parallel mesh (parallel/mesh.py): the device stage and
        the device CRF run over its ranks, each on its rows of every chunk,
        and every rank returns the whole result, equal to one process's at
        the same (rounded) batch size. ``auto`` takes the host CRF when
        more than one process runs (crf/policy.py), as in the JAX package.
    """
    with span("video.episode"):
        backend = None
        if run_crf:
            from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

            backend = resolve_crf_backend(crf_backend, frames_u8.shape[1], frames_u8.shape[2],
                                          device=device)
        with span("video.upload"):
            frames = torch.from_numpy(np.ascontiguousarray(frames_u8, dtype=np.uint8)).to(device)
        with span("video.device_stage"):
            preds, max_value, diff_chunks, valids, recons = episode_device_stage(
                vae, critic, frames, batch_size, compute_dtype=compute_dtype,
                with_recons=with_recons, recons_u8=recons_u8, mask_source=mask_source,
                saliency_opts=saliency_opts, mesh=mesh,
            )
        with span("video.normalize"):
            # global two-pass normalisation: the mean of the trimmed per-frame maxima
            mean_max = torch.mean(max_value)
            t = torch.tensor([threshold], dtype=torch.int32, device=device)
            u8_parts, thr_parts = [], []
            for diff, valid in zip(diff_chunks, valids):
                u8 = normalize_diffs_given_mean(diff, mean_max)[:valid]
                u8_parts.append(u8)
                thr_parts.append(threshold_masks(u8, t)[0])

        crf = None
        if backend == "device":
            # every rank holds every mask: under a mesh the device CRF splits
            # them again (the JAX package's multi-process branch refines them
            # after its fetch, which the gathered masks are here)
            with span("video.crf"):
                crf = _refine(frames, torch.cat(thr_parts), crf_params, "device", mesh=mesh)
        with span("video.readback"):
            diff_u8 = torch.cat(u8_parts).cpu().numpy()
        if backend == "host":
            # each chunk's masks to the host, refined there while the next come
            with span("video.crf"), concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
                futures, host_thr, off = [], [], 0
                for thr_c in thr_parts:
                    with span("video.readback"):
                        host_thr.append(thr_c.cpu().numpy())
                    futures.append(pool.submit(_refine, frames_u8[off : off + len(host_thr[-1])],
                                               host_thr[-1], crf_params, "host", num_threads))
                    off += len(host_thr[-1])
                thr_masks = np.concatenate(host_thr)
                crf_masks = np.concatenate([f.result() for f in futures])
        else:
            with span("video.readback"):
                thr_masks = torch.cat(thr_parts).cpu().numpy()
                crf_masks = crf.cpu().numpy() if crf is not None else None
        with span("video.readback"):
            preds_host = preds.cpu().numpy()
        with span("video.score"):
            thr_iou = iou(gt, thr_masks) if gt is not None else None
            crf_iou = iou(gt, crf_masks) if gt is not None and crf_masks is not None else None
    return EpisodeResult(
        preds=preds_host,
        recon_one=recons[0] if recons else None,
        recon_zero=recons[1] if recons else None,
        diff_u8=diff_u8,
        thr_masks=thr_masks,
        crf_masks=crf_masks,
        thr_iou=thr_iou,
        crf_iou=crf_iou,
    )


def threshold_sweep(vae: VAE, critic: Critic, frames_u8: np.ndarray, gt: np.ndarray,
                    thresholds: Sequence[int] = DEFAULT_SWEEP, *, device: torch.device,
                    crf_params: Tuple = REFERENCE_CRF_PARAMS, run_crf: bool = True,
                    batch_size: int = 512, num_threads: int = 0,
                    compute_dtype: str = "float32", crf_backend: str = "auto",
                    mask_source: str = "diff", saliency_opts: Optional[Dict] = None,
                    mesh=None) -> List[Dict]:
    """Threshold sweep with the device stage run once (reference: -video
    -thresh, which re-runs the whole pipeline per threshold).

    All T threshold masks and their whole-stack IoUs come from one
    vectorised pass on the device; the device CRF refines the T mask sets
    together (crf/device.py::refine_masks_multi_device) and its IoUs are
    counted on the device too, while the host CRF refines them one
    threshold at a time. Returns one dict per threshold: ``threshold``,
    ``thr_iou`` (3 digits) and ``crf_iou`` (3 digits, None without
    ``run_crf``). Arguments as in :func:`eval_episode` (``mask_source``,
    ``saliency_opts`` and ``mesh`` too); ``gt`` is required.
    """
    backend = None
    if run_crf:
        from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

        backend = resolve_crf_backend(crf_backend, frames_u8.shape[1], frames_u8.shape[2],
                                      device=device)
    frames = torch.from_numpy(np.ascontiguousarray(frames_u8, dtype=np.uint8)).to(device)
    gt_dev = torch.from_numpy(np.ascontiguousarray(gt, dtype=bool)).to(device)
    _, max_value, diff_chunks, valids, _ = episode_device_stage(
        vae, critic, frames, batch_size, compute_dtype=compute_dtype,
        mask_source=mask_source, saliency_opts=saliency_opts, mesh=mesh,
    )
    mean_max = torch.mean(max_value)
    t = torch.tensor(list(thresholds), dtype=torch.int32, device=device)
    counts = torch.zeros((3, len(t)), dtype=torch.int64, device=device)
    mask_parts = []
    offset = 0
    for diff, valid in zip(diff_chunks, valids):
        masks = _normalize_threshold_chunk(diff, mean_max, t)[1][:, :valid]
        counts += torch.stack(_sweep_chunk_stats(masks, gt_dev[offset : offset + valid]))
        if run_crf:
            mask_parts.append(masks)
        offset += valid
    thr_ious = _ious(counts)

    crf_ious = [None] * len(t)
    if backend == "device":
        from critic_vae_tpu_torch.crf.device import refine_masks_multi_device

        refined = refine_masks_multi_device(frames, torch.cat(mask_parts, dim=1), crf_params,
                                            fetch=False, mesh=mesh)
        crf_ious = [round(v, 3) for v in _ious(torch.stack(_sweep_chunk_stats(refined, gt_dev)))]
    elif backend == "host":
        masks = torch.cat(mask_parts, dim=1).cpu().numpy()
        crf_ious = [iou(gt, _refine(frames_u8, m, crf_params, "host", num_threads))
                    for m in masks]
    return [{"threshold": int(th), "thr_iou": round(thr_ious[i], 3), "crf_iou": crf_ious[i]}
            for i, th in enumerate(thresholds)]


def _ious(counts: torch.Tensor) -> List[float]:
    """(3, T) (tp, fn, fp) counts -> T IoUs with ops/iou.py semantics:
    Python-int counts, float64 division, 0/0 -> 1."""
    tp, fn, fp = counts.cpu().tolist()
    return [1.0 if a + b + c == 0 else a / (a + b + c) for a, b, c in zip(tp, fn, fp)]


def bin_diagnostics(preds: np.ndarray, gt: np.ndarray, thr_masks: np.ndarray) -> Dict:
    """Per-critic-bin IoU, frame and ground-truth-pixel diagnostics
    (reference: save_bin_info, vae_utility.py:112-145). Bins are round(pred,
    1) in first-seen order, as the reference's defaultdicts."""
    per_frame_iou = iou_batch(thr_masks, gt)  # the reference's argument order: (mask, gt)
    bin_ious: Dict[float, List[float]] = defaultdict(list)
    bin_frames: Dict[float, int] = defaultdict(int)
    bin_gts: Dict[float, int] = defaultdict(int)
    for i, pred in enumerate(preds):
        b = round(float(pred), 1)
        bin_ious[b].append(round(float(per_frame_iou[i]), 3))
        bin_frames[b] += 1
        bin_gts[b] += int(np.sum(gt[i]))
    return {"ious": dict(bin_ious), "frames": dict(bin_frames), "gts": dict(bin_gts)}


def write_bin_info(diag: Dict, out_path: str, total_frames: int) -> None:
    """Write the bin_info text file in the reference's format, with the JAX
    package's two fixes: frame shares divide by the real frame count (the
    reference divides by 1200), and a bin of one frame reports std 0.0."""
    import statistics

    total_gt = sum(diag["gts"].values())
    with open(out_path, "w") as f:
        f.write("ground truth pixels sorted by bin:\n")
        for b, count in diag["gts"].items():
            pct = round(count / total_gt, 2) * 100 if total_gt else 0.0
            f.write(f"bin: {b}, pixels = {count} = {pct}%\n")
        f.write("\nframes separated by bin:\n")
        for b, count in diag["frames"].items():
            f.write(f"bin: {b}, frames = {count} = {round(count / total_frames, 2) * 100}%\n")
        f.write("\niou-mean and std:\n")
        for b, ious in diag["ious"].items():
            mean = round(statistics.mean(ious), 2)
            std = round(statistics.stdev(ious), 2) if len(ious) > 1 else 0.0
            f.write(f"bin: {b}, iou_mean={mean}, iou_std={std}\n")


def compose_frames(frames_u8: np.ndarray, result: EpisodeResult, gt: Optional[np.ndarray],
                   threshold: int) -> List:
    """The annotated strips (Pillow, on the host): 7 panels with ground
    truth, 6 without; ``result`` must hold the reconstructions."""
    from critic_vae_tpu_torch.viz.panels import final_frame

    crf = result.crf_masks if result.crf_masks is not None else np.zeros_like(result.thr_masks)
    return [
        final_frame(frames_u8[i], result.recon_one[i], result.recon_zero[i], result.diff_u8[i],
                    result.preds[i], gt=gt[i] if gt is not None else None,
                    thr_mask=result.thr_masks[i], crf_mask=crf[i], thr_iou=result.thr_iou,
                    crf_iou=result.crf_iou, threshold=threshold)
        for i in range(len(frames_u8))
    ]
