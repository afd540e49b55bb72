"""Video / mask-evaluation pipeline (counterpart of
critic_vae_tpu/pipelines/video.py).

Per frame: critic score, encode, double decode, diff/grey/max (kernel B1),
or with ``mask_source="saliency"`` the critic's saliency maps instead,
then the global mean-max normalisation to uint8, the threshold, the dense
CRF and whole-stack IoU. The CRF is the exact device mean field (kernel B2,
or the ``xla``/``int8``/``vmem`` builds) or the host C++ lattice, as
crf/policy.py resolves it. ``eval_episode`` keeps everything up to the masks
on the device, counts each IoU's (tp, fn, fp) there and divides the counts
on the host. ``threshold_sweep`` runs the device stage once and scores
every threshold on the device (the host CRF refines per threshold).
With ``mesh=`` (parallel/mesh.py) each rank runs the device stage and the
device CRF on its rows of every chunk and the rows are gathered, so every
rank holds the whole result, as the JAX package's meshed runs. ``bin_diagnostics``/``write_bin_info`` write the
reference's bin_info file, ``compose_frames`` the annotated strips of the
GIF (Pillow, imported only there). Under a profiler each ``eval_episode``
is a ``video.episode`` span holding its stages' spans (upload, device
stage, normalise and threshold, CRF, read-backs, scoring;
utils/profiling.py::span), and each ``threshold_sweep`` a ``video.sweep``
span holding the same stages, with ``sweep.threshold`` a chunk for its
normalisation, T masks and counts. The first call of each in the process
is also the set-up span ``setup.first_call`` (``video.episode``,
``video.sweep``; utils/profiling.py::setup_span): it holds the lazy work
of set-up (cuDNN's choices, the allocator's growth, :class:`_Staging`'s
ring, the CRF's plan, the kernel library's load) besides the call's own.

On a CUDA device an episode's copies between host and card are
asynchronous, go through pinned host memory and run on a side stream
beside the card's work, each queued as soon as its data is ready: each
chunk's frames just before the chunk, in pieces through a staging buffer
kept across calls (:class:`_Staging`), so the card computes chunk k while
the host copies chunk k+1; the ground truth while the card runs the last
chunk; the maps, threshold masks and scores, back while the card runs the
CRF, into fresh pinned blocks that the returned arrays use. The host waits
once, at the end, for all of it. :data:`COPIES` counts the copies. On the
CPU nothing moves, and the arrays are the tensors' own memory, as ever.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf.terms import _spatial_taps
from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE
from critic_vae_tpu_torch.ops.iou import iou_batch
from critic_vae_tpu_torch.ops.mask import (
    episode_forward,
    iou_counts,
    ious_from_counts,
    normalize_diffs_given_mean,
    threshold_masks,
)
from critic_vae_tpu_torch.utils.profiling import setup_span, span

# the reference's -thresh sweep (vae.py:121-123): 0..120 step 10
DEFAULT_SWEEP = tuple(range(0, 130, 10))

# the pipeline's copies between host and card since the last reset_copies(),
# and their bytes, by kind: through pinned host memory (CUDA: one a staged
# piece or a read-back) or pageable (another accelerator's plain .to() and
# .cpu()); the CPU copies nothing
COPIES = {"pinned": 0, "pinned_bytes": 0, "pageable": 0, "pageable_bytes": 0}


def reset_copies() -> None:
    for kind in COPIES:
        COPIES[kind] = 0


# threshold_sweep's calls since the last reset_sweeps(), the thresholds they
# scored and the mask sets their CRF refined (a threshold's set a call)
SWEEPS = {"calls": 0, "thresholds": 0, "mask_sets_refined": 0}


def reset_sweeps() -> None:
    for key in SWEEPS:
        SWEEPS[key] = 0


def _count(kind: str, nbytes: int) -> None:
    COPIES[kind] += 1
    COPIES[kind + "_bytes"] += nbytes


class _Staging:
    """Pinned host memory that uploads to a card pass through, kept across
    calls: slots of ``PIECE`` bytes taken in turn as a ring, as many as the
    largest upload so far fills. The host copies piece k+1 into its slot
    while the card copies piece k out of its own; each slot's event,
    recorded behind the slot's copy to the card, keeps the host from
    writing a slot whose copy is still in flight. The host's copy is
    numpy's, on one thread: torch's copy runs on a team of threads that
    waits for its slowest, and on a host shared with other work that
    stalled it for up to 20 ms."""

    PIECE = 2 << 20

    def __init__(self):
        self.slots: List[torch.Tensor] = []
        self.copied: List[torch.cuda.Event] = []
        self.next = 0
        self.lock = threading.Lock()

    def upload(self, src: np.ndarray, out: torch.Tensor, stream) -> None:
        """Queue the copy of C-contiguous ``src`` into ``out`` (on the
        card, as many bytes) on ``stream``, the current stream."""
        src, dst = src.reshape(-1).view(np.uint8), out.view(-1).view(torch.uint8)
        n = src.size
        with self.lock:
            while len(self.slots) * self.PIECE < n:
                self.slots.append(torch.empty(self.PIECE, dtype=torch.uint8, pin_memory=True))
                self.copied.append(torch.cuda.Event())
            for a in range(0, n, self.PIECE):
                b = min(a + self.PIECE, n)
                k, self.next = self.next, (self.next + 1) % len(self.slots)
                self.copied[k].synchronize()  # returns at once for an event never recorded
                slot = self.slots[k][: b - a]
                np.copyto(slot.numpy(), src[a:b])
                dst[a:b].copy_(slot, non_blocking=True)
                self.copied[k].record(stream)
                _count("pinned", b - a)


_STAGING = _Staging()
_SIDE: Dict[int, torch.cuda.Stream] = {}


def _side_stream(device: torch.device):
    """The card's side stream, for the copies that overlap its work (kept
    across calls); None off CUDA."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(index)
    return _SIDE[index]


def _to_device(host: np.ndarray, device: torch.device, stream=None) -> torch.Tensor:
    """C-contiguous ``host`` on ``device``. To a card through
    :class:`_Staging`, on ``stream`` (default the current stream), returning
    once the last piece is queued: a tensor that came up on another stream
    is marked as used by the current one, which waits for it before
    reading it. Elsewhere ``.to(device)``."""
    src = torch.from_numpy(host)
    if device.type != "cuda":
        if device.type != "cpu":
            _count("pageable", src.nbytes)
        return src.to(device)
    current = torch.cuda.current_stream(device)
    stream = stream or current
    with torch.cuda.stream(stream):
        out = torch.empty_like(src, device=device)
        _STAGING.upload(host, out, stream)
    if stream != current:
        out.record_stream(current)
    return out


def _frames_by_chunk(host: np.ndarray, device: torch.device, side):
    """The (N, H, W, 3) uint8 frames on ``device``, and the function that
    copies rows [start, stop) there, for :func:`episode_device_stage`'s
    ``before_chunk`` (None: every row is there). On a card the rows go up
    on the ``side`` stream, a chunk's just before the chunk, so the card
    computes chunk k while the host copies chunk k+1; the current stream
    waits for them. Elsewhere the frames go at once, as ``.to(device)``."""
    if side is None:
        with span("video.upload"):
            return _to_device(host, device), None
    current = torch.cuda.current_stream(device)
    with torch.cuda.stream(side):
        frames = torch.empty(host.shape, dtype=torch.uint8, device=device)
    frames.record_stream(current)

    def upload(start: int, stop: int) -> None:
        with span("video.upload"):
            with torch.cuda.stream(side):
                _STAGING.upload(host[start:stop], frames[start:stop], side)
            current.wait_stream(side)

    return frames, upload


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as numpy. A card's tensor is copied on the current stream,
    without waiting, into a fresh block of pinned memory from torch's
    caching host allocator, which hands the block out again only once the
    array is dropped and the copy done: the array holds the values once the
    stream has passed the copy (:func:`_join`). Elsewhere ``.cpu()``, which
    on the CPU is the tensor's own memory."""
    if not t.is_cuda:
        if t.device.type != "cpu":
            _count("pageable", t.nbytes)
        return t.cpu().numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    t.record_stream(torch.cuda.current_stream(t.device))
    _count("pinned", out.nbytes)
    return out.numpy()


def _to_host_beside(side, tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """:func:`_to_host` of ``tensors`` on the ``side`` stream, behind
    everything queued so far on the current one (None: the current one)."""
    if side is None:
        return [_to_host(t) for t in tensors]
    side.wait_stream(torch.cuda.current_stream(side.device))
    with torch.cuda.stream(side):
        return [_to_host(t) for t in tensors]


def _join(device: torch.device, side=None) -> None:
    """The host's one wait: for all the card's work queued so far on the
    current stream and on ``side``."""
    if device.type != "cuda":
        return
    current = torch.cuda.current_stream(device)
    if side is not None:
        current.wait_stream(side)
    done = torch.cuda.Event()
    done.record(current)
    done.synchronize()


def _normalize_threshold_chunk(diff: torch.Tensor, mean_max: torch.Tensor,
                               thresholds: torch.Tensor):
    """One chunk's mean-max normalisation to uint8 and its (T, B, H, W)
    masks for all thresholds at once."""
    u8 = normalize_diffs_given_mean(diff, mean_max)
    return u8, threshold_masks(u8, thresholds)


def _refine(frames_u8, thr_masks, crf_params, backend: str, num_threads: int = 0,
            mesh=None, taps=None):
    """CRF refinement on ``backend``: ``device`` (the exact mean field of
    crf/device.py, on the masks' device, over ``mesh`` when given, with the
    spatial ``taps`` already there when given) or ``host`` (the C++ lattice
    on numpy arrays)."""
    if backend == "device":
        from critic_vae_tpu_torch.crf.device import refine_masks_device

        return refine_masks_device(frames_u8, thr_masks, crf_params, fetch=False, mesh=mesh,
                                   taps=taps)
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
                         mesh=None, before_chunk=None):
    """Run :func:`episode_forward` over device-resident uint8 frames (N, H,
    W, 3) in chunks of ``batch_size``, the last padded by repeating its last
    frame, so every chunk has one shape, each chunk inside a
    ``video.device_stage`` span. ``vae`` may be None for the saliency
    source without ``with_recons``, which never decodes. ``before_chunk``,
    when given, is called with a chunk's (start, stop) rows before the
    chunk's span opens (:func:`eval_episode` copies the chunk's frames to
    the card there).

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
    padded), each chunk's count of valid frames, and with ``with_recons``
    the trimmed (recon_one, recon_zero) (else None), all on the device."""
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
        if before_chunk is not None:
            before_chunk(i, min(i + batch_size, n))
        with span("video.device_stage"):
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
                    part.append(out[key][:valid])
    if with_recons:
        recons = tuple(torch.cat(part) for part in recons)
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
      gt: (N, H, W) bool ground truth, or None to skip IoU scoring. It goes
        to ``device`` after the frames; each whole-stack IoU is counted
        there (ops/mask.py::iou_counts) and divided on the host
        (``ious_from_counts``), bitwise ops/iou.py::iou of the returned
        masks. The host CRF's masks go back to ``device`` to be counted the
        same way. Under a ``mesh`` each rank counts the gathered masks
        itself, with no collective.
      crf_backend: "auto", "device" or "host" (crf/policy.py). The device
        CRF's build is ``auto`` unless ``CRITIC_VAE_TPU_CRF_BUILD`` names
        another (crf/device.py::_resolve_build), as in the JAX package. The
        host CRF refines the threshold masks once they reach the host, on
        ``num_threads`` OpenMP threads (0: OpenMP's default).
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
    device = torch.device(device)
    with setup_span("setup.first_call", "video.episode"), span("video.episode"):
        backend = None
        if run_crf:
            from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

            backend = resolve_crf_backend(crf_backend, frames_u8.shape[1], frames_u8.shape[2],
                                          device=device)
        side = _side_stream(device)
        frames, upload = _frames_by_chunk(np.ascontiguousarray(frames_u8, dtype=np.uint8),
                                          device, side)
        preds, max_value, diff_chunks, valids, recons = episode_device_stage(
            vae, critic, frames, batch_size, compute_dtype=compute_dtype,
            with_recons=with_recons, recons_u8=recons_u8, mask_source=mask_source,
            saliency_opts=saliency_opts, mesh=mesh, before_chunk=upload,
        )
        with span("video.upload"):
            # needed only after the device stage: up on the side stream while
            # the card runs it, the current stream waiting for them behind it
            gt_dev = (_to_device(np.ascontiguousarray(gt, dtype=bool), device, side)
                      if gt is not None else None)
            taps = (_to_device(_spatial_taps(float(crf_params[4]), *frames_u8.shape[1:3]),
                               device, side) if backend == "device" else None)
            if side is not None:
                torch.cuda.current_stream(device).wait_stream(side)
        with span("video.normalize"):
            # global two-pass normalisation: the mean of the trimmed per-frame maxima
            mean_max = torch.mean(max_value)
            t = torch.full((1,), threshold, dtype=torch.int32, device=device)
            u8_parts, thr_parts = [], []
            for diff, valid in zip(diff_chunks, valids):
                u8 = normalize_diffs_given_mean(diff, mean_max)[:valid]
                u8_parts.append(u8)
                thr_parts.append(threshold_masks(u8, t)[0])
            thr_all = torch.cat(thr_parts)
        with span("video.readback"):
            # final now: back on the side stream while the card counts and
            # runs the CRF
            diff_u8, thr_masks, preds_host, *recons = _to_host_beside(
                side, [torch.cat(u8_parts), thr_all, preds, *(recons or ())])
        counts = [iou_counts(gt_dev, thr_all)] if gt_dev is not None else []
        crf = crf_masks = None
        if backend == "device":
            # every rank holds every mask: under a mesh the device CRF splits
            # them again (the JAX package's multi-process branch refines them
            # after its fetch, which the gathered masks are here)
            with span("video.crf"):
                crf = _refine(frames, thr_all, crf_params, "device", mesh=mesh, taps=taps)
        elif backend == "host":
            with span("video.crf"):
                _join(device, side)
                crf_masks = _refine(frames_u8, thr_masks, crf_params, "host", num_threads)
            if gt_dev is not None:
                with span("video.upload"):
                    crf = _to_device(np.ascontiguousarray(crf_masks), device)
        if crf is not None and gt_dev is not None:
            counts.append(iou_counts(gt_dev, crf))
        with span("video.readback"):
            if backend == "device":
                crf_masks = _to_host(crf)
            counts_host = _to_host(torch.stack(counts)) if counts else None
            _join(device, side)
        with span("video.score"):
            thr_iou = crf_iou = None
            if counts_host is not None:
                ious = ious_from_counts(counts_host)
                thr_iou, crf_iou = ious[0], ious[1] if len(ious) > 1 else None
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
    ``thr_iou`` (3 digits), ``crf_iou`` (3 digits, None without
    ``run_crf``), and the whole-stack counts the IoUs divide, unrounded:
    ``thr_counts`` and ``crf_counts`` (tp, fn, fp) as ints (``crf_counts``
    None without ``run_crf``). Arguments as in :func:`eval_episode`
    (``mask_source``, ``saliency_opts`` and ``mesh`` too); ``gt`` is
    required.

    Under a profiler the call is a ``video.sweep`` span holding
    ``video.upload`` (frames, ``gt``, thresholds, taps), the device stage's
    ``video.device_stage`` a chunk, ``sweep.threshold`` a chunk (its
    normalisation, the T masks and their counts), ``video.crf`` (the T sets
    refined), ``video.readback`` (the counts back, the wait) and
    ``video.score``; :data:`SWEEPS` counts the calls, thresholds and mask
    sets refined.
    """
    device = torch.device(device)
    with setup_span("setup.first_call", "video.sweep"), span("video.sweep"):
        backend = None
        if run_crf:
            from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

            backend = resolve_crf_backend(crf_backend, frames_u8.shape[1], frames_u8.shape[2],
                                          device=device)
        with span("video.upload"):
            frames = _to_device(np.ascontiguousarray(frames_u8, dtype=np.uint8), device)
            gt_dev = _to_device(np.ascontiguousarray(gt, dtype=bool), device)
            t = _to_device(np.array(thresholds, dtype=np.int32), device)
            taps = (_to_device(_spatial_taps(float(crf_params[4]), *frames_u8.shape[1:3]), device)
                    if backend == "device" else None)
        _, max_value, diff_chunks, valids, _ = episode_device_stage(
            vae, critic, frames, batch_size, compute_dtype=compute_dtype,
            mask_source=mask_source, saliency_opts=saliency_opts, mesh=mesh,
        )
        mean_max = torch.mean(max_value)
        counts = torch.zeros((len(t), 3), dtype=torch.int64, device=device)
        mask_parts = []
        offset = 0
        for diff, valid in zip(diff_chunks, valids):
            with span("sweep.threshold"):
                masks = _normalize_threshold_chunk(diff, mean_max, t)[1][:, :valid]
                counts += iou_counts(gt_dev[offset : offset + valid], masks)
            if run_crf:
                mask_parts.append(masks)
            offset += valid
        with span("video.readback"):
            thr_counts, crf_counts, crf_masks = _to_host(counts), None, None
        if backend == "device":
            from critic_vae_tpu_torch.crf.device import refine_masks_multi_device

            with span("video.crf"):
                refined = refine_masks_multi_device(frames, torch.cat(mask_parts, dim=1),
                                                    crf_params, fetch=False, mesh=mesh, taps=taps)
            crf_counts = iou_counts(gt_dev, refined)
        with span("video.readback"):
            if crf_counts is not None:
                crf_counts = _to_host(crf_counts)
            elif backend == "host":
                crf_masks = _to_host(torch.cat(mask_parts, dim=1))
            _join(device)
        if backend == "host":
            with span("video.crf"):
                refined = np.stack([_refine(frames_u8, m, crf_params, "host", num_threads)
                                    for m in crf_masks])
            crf_counts = iou_counts(torch.from_numpy(np.ascontiguousarray(gt, dtype=bool)),
                                    torch.from_numpy(refined)).numpy()
        with span("video.score"):
            thr_ious = ious_from_counts(thr_counts)
            crf_ious = [None] * len(t)
            if crf_counts is not None:
                crf_ious = ious_from_counts(crf_counts)
        SWEEPS["calls"] += 1
        SWEEPS["thresholds"] += len(t)
        SWEEPS["mask_sets_refined"] += len(t) if backend is not None else 0
    return [{"threshold": int(th), "thr_iou": thr_ious[i], "crf_iou": crf_ious[i],
             "thr_counts": tuple(int(c) for c in thr_counts[i]),
             "crf_counts": None if crf_counts is None else tuple(int(c) for c in crf_counts[i])}
            for i, th in enumerate(thresholds)]


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
