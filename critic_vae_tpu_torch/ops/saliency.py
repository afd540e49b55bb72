"""Critic saliency maps, the ``saliency`` mask source (counterpart of
critic_vae_tpu/ops/saliency.py).

Instead of the VAE's reconstruction difference, the frozen critic is asked
where its evidence lies:

* ``gradient``: |d score / d x| summed over the colour channels, the score
  being the probability or, with ``logits``, the pre-sigmoid logit;
* ``layercam`` (Jiang et al. 2021): ReLU(d logit / d A * A) summed over the
  channels of block ``cam_block``'s post-pool activation A, upsampled to the
  frame by ``jax.image.resize``'s kernel (ops/resize.py) and clamped at 0;
* SmoothGrad (``samples``, ``noise``): the map averaged over copies of the
  frames with N(0, noise^2) pixel noise;
* test-time augmentation (``tta_flip``, ``tta_shift``): the raw maps of the
  {id, mirror} x {0, +-shift px} views, each mapped back, min-combined, the
  columns a shift wrapped round set to +inf first;
* a separable Gaussian blur with edge replication (``smooth_sigma``).

Frames are NCHW here (the JAX package's are NHWC), so a horizontal flip or
shift of the frames acts on dim 3 and of the (B, H, W) maps on dim 2.

The stage runs in float32 with TF32 off, as the JAX package's blur and
resize run at ``Precision.HIGHEST``, whatever the caller's dtype, and with
autograd on even inside ``torch.inference_mode``: an inference tensor given
to it is cloned first, since autograd cannot save one for its backward. The
probability is ``torch.sigmoid`` of the logit, whose backward is y(1 - y),
as ``jax.nn.sigmoid``'s; the critic's op-by-op sigmoid (models/critic.py)
would give NaN gradients at saturated logits.

SmoothGrad's noise comes from a ``torch.Generator``; JAX's threefry stream
cannot be reproduced, so :func:`critic_saliency_from_noise` takes the unit
normal draws themselves, (samples, B, H, W, 3) in the frames' (B, H, W, 3)
layout, and every TTA view reuses them, as JAX reuses its key.

The stage runs as parts (:func:`_parts`): each view (its input flipped and
rolled, the critic's forward, the backward passes and the map), each
LayerCAM upsample (the resize and the clamp) and each further view's
mapping back (roll and flip back, the +inf border, the minimum), under a
profiler inside the spans ``saliency.view``, ``saliency.upsample`` and
``saliency.combine`` (utils/profiling.py::span). On a card without
SmoothGrad the parts replay as CUDA graphs from a signature's second call
(:class:`_SaliencyGraphs`), each inside its span, with the kernels and
results of the eager parts; a capture is the set-up span ``setup.capture``
(key ``saliency:`` and the frames' shape; utils/profiling.py::setup_span).
:data:`VIEWS` counts the views and the backward passes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.device import no_tf32
from critic_vae_tpu_torch.ops.resize import METHODS as CAM_UPSAMPLES
from critic_vae_tpu_torch.ops.resize import resize_maps
from critic_vae_tpu_torch.utils.profiling import setup_span, span

DEFAULT_SMOOTH_SIGMA = 1.5  # the JAX package's measured best for "gradient"
METHODS = ("gradient", "layercam")

# the views run since the last reset_views() (one a view of a batch: the
# clean one and each TTA view) and their backward passes (one a view, or
# one a SmoothGrad sample)
VIEWS = {"views": 0, "backward": 0}


def reset_views() -> None:
    for kind in VIEWS:
        VIEWS[kind] = 0


def gaussian_taps(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps truncated at 4σ (scipy's default)."""
    radius = max(1, int(4.0 * sigma + 0.5))
    k = np.arange(-radius, radius + 1, dtype=np.float32)
    taps = np.exp(-0.5 * (k / np.float32(sigma)) ** 2)
    return (taps / taps.sum()).astype(np.float32)


def _sep_blur(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 2-D blur of (B, H, W) maps with edge-replicate padding: a
    1-D conv along H, then along W, in float32."""
    r = taps.shape[0] // 2
    y = F.pad(x[:, None].float(), (r, r, r, r), mode="replicate")
    y = F.conv2d(y, taps.float().view(1, 1, -1, 1))
    return F.conv2d(y, taps.float().view(1, 1, 1, -1))[:, 0]


def _check_options(samples, noise, method, cam_block, cam_upsample, tta_shift) -> None:
    """The JAX ``critic_saliency``'s argument errors, in its order."""
    if samples < 1:
        raise ValueError(
            f"critic_saliency: samples must be >= 1, got {samples} "
            "(0 would average over an empty axis and yield all-NaN maps)"
        )
    if noise < 0.0:
        raise ValueError(f"critic_saliency: noise must be >= 0, got {noise}")
    if method not in METHODS:
        raise ValueError(f"critic_saliency: unknown method {method!r} (gradient|layercam)")
    if method == "layercam" and not 0 <= cam_block <= 3:
        raise ValueError(f"critic_saliency: cam_block must be in 0..3, got {cam_block}")
    if cam_upsample not in CAM_UPSAMPLES:
        raise ValueError(
            f"critic_saliency: unknown cam_upsample {cam_upsample!r} "
            "(bilinear|bicubic|lanczos3|nearest)"
        )
    if tta_shift < 0:
        raise ValueError(f"critic_saliency: tta_shift must be >= 0, got {tta_shift}")


def critic_saliency(critic, x: torch.Tensor, *, smooth_sigma: float | None = None,
                    logits: bool = False, samples: int = 1, noise: float = 0.0,
                    generator: torch.Generator | None = None, method: str = "gradient",
                    cam_block: int = 1, cam_upsample: str = "lanczos3",
                    tta_flip: bool = False, tta_shift: int = 0,
                    noise_rows: tuple | None = None):
    """Saliency maps and predictions for a batch of NCHW frames ``x`` (B, 3,
    H, W) in [0, 1], as the JAX ``critic_saliency`` with a
    ``torch.Generator`` where it takes a key.

    ``smooth_sigma=None`` is the per-method default (1.5 for ``gradient``, 0
    for ``layercam``); 0 disables the blur. ``noise == 0`` is one backward
    pass whatever ``samples``; ``noise > 0`` draws (samples, B, H, W, 3)
    unit normals from ``generator`` (required, on x's device) and averages
    the maps of ``x + noise * draw``; with ``noise_rows=(start, total)`` the
    draw is that of a batch of ``total`` frames, of which ``x`` holds rows
    start.. (a rank's rows under a mesh). ``logits`` differentiates the logit
    (``gradient`` only; ``layercam`` always does). Returns (preds (B,), the
    clean view's probabilities, and saliency (B, H, W)), float32 on x's
    device, outside any autograd graph."""
    _check_options(samples, noise, method, cam_block, cam_upsample, tta_shift)
    draws = None
    if noise > 0.0:
        if generator is None:
            raise ValueError("critic_saliency: SmoothGrad (noise>0) requires a PRNG key "
                             "(a torch.Generator)")
        b, c, h, w = x.shape
        start, total = noise_rows if noise_rows is not None else (0, b)
        draws = torch.randn((samples, total, h, w, c), generator=generator, device=x.device,
                            dtype=torch.float32)[:, start : start + b]
    return critic_saliency_from_noise(
        critic, x, draws, smooth_sigma=smooth_sigma, logits=logits, noise=noise,
        method=method, cam_block=cam_block, cam_upsample=cam_upsample, tta_flip=tta_flip,
        tta_shift=tta_shift)


def critic_saliency_from_noise(critic, x: torch.Tensor, draws: torch.Tensor | None, *,
                               smooth_sigma: float | None = None, logits: bool = False,
                               noise: float = 0.0, method: str = "gradient",
                               cam_block: int = 1, cam_upsample: str = "lanczos3",
                               tta_flip: bool = False, tta_shift: int = 0):
    """:func:`critic_saliency` with SmoothGrad's unit normal ``draws`` given:
    (samples, B, H, W, 3), the layout of JAX's ``jax.random.normal(k,
    x.shape)`` over ``jax.random.split(key, samples)``, or None when
    ``noise == 0``."""
    samples = 1 if draws is None else draws.shape[0]
    _check_options(samples, noise, method, cam_block, cam_upsample, tta_shift)
    if noise > 0.0 and draws is None:
        raise ValueError("critic_saliency: SmoothGrad (noise>0) requires a PRNG key "
                         "(a torch.Generator)")
    if smooth_sigma is None:
        smooth_sigma = DEFAULT_SMOOTH_SIGMA if method == "gradient" else 0.0
    with torch.inference_mode(False), torch.enable_grad(), no_tf32():
        x = x.float()
        x = x.clone() if x.is_inference() else x
        z = None
        if noise > 0.0:
            z = draws.float().permute(0, 1, 4, 2, 3)  # NHWC draws -> NCHW
            z = z.clone() if z.is_inference() else z
        options = dict(smooth_sigma=smooth_sigma, logits=logits, noise=noise, method=method,
                       cam_block=cam_block, cam_upsample=cam_upsample, tta_flip=tta_flip,
                       tta_shift=tta_shift)
        if x.is_cuda and z is None:
            preds, sal = _GRAPHS(critic, x, options)
        else:
            preds, sal = _eager(_parts(critic, x, z, **options))
    return preds.detach().float(), sal.detach().float()


def _parts(critic, x, z, *, tta_flip, tta_shift, **one):
    """The saliency stage of frames ``x`` as its parts, in order: the
    generator yields the span name of each part before running it, then
    (preds, saliency), the clean view's scores and the combined maps, and
    stays suspended there, its frame holding every tensor the parts read
    and write. :func:`_eager` runs each part in its span; :class:`_Captured`
    captures each as a CUDA graph."""
    preds, sal = yield from _view(critic, x, z, **one)
    shifts = (0, tta_shift, -tta_shift) if tta_shift else (0,)
    for flip in ((False, True) if tta_flip else (False,)):
        for dx in shifts:
            if not flip and dx == 0:
                continue  # the clean view above
            _, m = yield from _view(critic, x, z, flip=flip, shift=dx, **one)
            yield "saliency.combine"
            if dx:
                m = torch.roll(m, -dx, dims=2)
            if flip:
                # the border below is set in un-flipped coordinates
                m = m.flip(2)
                dx = -dx
            if dx:
                # a +dx roll brought the frame's right-edge columns in at the
                # view's left edge; rolled back, their map values lie on cols
                # >= W - dx (mirror-image for dx < 0)
                cols = torch.arange(m.shape[2], device=m.device)
                invalid = cols >= m.shape[2] - dx if dx > 0 else cols < -dx
                m = torch.where(invalid[None, None, :], torch.inf, m)
            sal = torch.minimum(sal, m)
    yield preds, sal


def _eager(parts):
    """Run the generator ``parts`` (:func:`_parts`, :func:`_view`) part by
    part, each inside the span it names; the result it yields or returns
    after its last part."""
    try:
        item = next(parts)
        while isinstance(item, str):
            with span(item):
                if item == "saliency.view":
                    VIEWS["views"] += 1
                item = next(parts)
    except StopIteration as stop:
        return stop.value
    return item


def _view(critic, x, z, *, smooth_sigma, logits, noise, method, cam_block, cam_upsample,
          flip=False, shift=0):
    """One view's parts (:func:`_parts`): ``saliency.view`` (the frames
    ``x`` mirrored with ``flip`` and then rolled by ``shift`` columns, the
    critic's forward, the backward passes and the raw map; with the
    ``gradient`` method the blur) and for ``layercam`` ``saliency.upsample``
    (the resize, the clamp and the blur); its value is (preds, the map in
    the view's coordinates)."""
    h, w = x.shape[2:]

    def sal_one(xb):
        """(logits (B,), the raw map) of frames ``xb`` from one backward."""
        VIEWS["backward"] += 1
        xb = xb.detach().requires_grad_(True)
        if method == "gradient":
            logit = critic(xb, return_logits=True)[:, 0]
            score = logit if logits else torch.sigmoid(logit)
            (g,) = torch.autograd.grad(score.sum(), xb)
            return logit.detach(), g.abs().sum(1)
        logit, a = critic(xb, return_logits=True, tap=cam_block)
        (g,) = torch.autograd.grad(logit[:, 0].sum(), a)
        return logit[:, 0].detach(), F.relu(g * a).sum(1)

    yield "saliency.view"
    if flip:
        x = x.flip(3)
    if shift:
        x = torch.roll(x, shift, dims=3)
    if noise > 0.0:
        acc = None
        for zs in z:
            m = sal_one(x + noise * zs)[1]
            acc = m if acc is None else acc + m
        sal = acc / z.shape[0]
        with torch.no_grad():
            logit = critic(x, return_logits=True)[:, 0]
    else:
        # noise == 0: every SmoothGrad copy would be the same
        logit, sal = sal_one(x)
    preds = torch.sigmoid(logit)
    if method == "layercam":
        # resize after averaging (linear, so the same at 1/samples the work);
        # Lanczos and cubic ring below 0, and the normalisation wants >= 0
        yield "saliency.upsample"
        sal = torch.clamp_min(resize_maps(sal, (h, w), cam_upsample), 0.0)
    if smooth_sigma and smooth_sigma > 0:
        sal = _sep_blur(sal, _blur_taps(float(smooth_sigma), sal.device))
    return preds, sal.detach()


@functools.lru_cache(maxsize=None)
def _blur_taps(sigma: float, device: torch.device) -> torch.Tensor:
    """:func:`gaussian_taps` on ``device``, uploaded once and shared (read
    only): an upload of pageable memory to a card waits for its queue."""
    with torch.inference_mode(False):
        return torch.from_numpy(gaussian_taps(sigma)).to(device)


class _Captured:
    """One signature's saliency stage captured as CUDA graphs, a graph a
    part (:func:`_parts`) in one memory pool. A replay copies the frames in,
    replays each part's graph inside the span it names, counts in
    :data:`VIEWS` what the captured parts ran, and returns copies of the
    outputs, which the next replay overwrites."""

    def __init__(self, critic, x: torch.Tensor, options: dict):
        self.x = x.clone()  # the static input; the graphs hold its address
        before = dict(VIEWS)
        with setup_span("setup.capture", "saliency:" + "x".join(map(str, x.shape))):
            # the generator's frame holds every tensor the graphs read and write
            self.parts = _parts(critic, self.x, None, **options)
            self.graphs = []
            pool = torch.cuda.graph_pool_handle()
            item = next(self.parts)
            while isinstance(item, str):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    following = next(self.parts)
                self.graphs.append((item, graph))
                item = following
        self.out = item
        self.counts = {k: VIEWS[k] - before[k] for k in VIEWS}
        self.counts["views"] = sum(1 for name, _ in self.graphs if name == "saliency.view")
        VIEWS.update(before)

    def replay(self, x: torch.Tensor):
        self.x.copy_(x)
        for name, graph in self.graphs:
            with span(name):
                graph.replay()
        for k, n in self.counts.items():
            VIEWS[k] += n
        return tuple(t.clone() for t in self.out)


_KEPT = 4  # signatures with graphs kept: an episode's chunks and its tail, for two critics


class _SaliencyGraphs:
    """The saliency stage on a card without SmoothGrad, by signature: a
    signature's first call runs eagerly (cuDNN's choices, the caching
    allocator, the cached matrices and taps), its second is captured
    (:class:`_Captured`) and replayed, and every later one replays, so the
    card no longer waits on the host's ~70 launches a view. The signature:
    the critic's identity and its parameters' addresses, the frames' shape,
    strides, dtype and device, the options, and the precision flags in
    force. The graphs of the last :data:`_KEPT` signatures captured are
    kept, so that an episode's full chunks and its shorter tail both replay;
    capturing one more frees the oldest first (each pool holds six views'
    activations). Replays compute what eager calls compute, with the same
    kernels on the same addresses."""

    def __init__(self):
        self.pending = {}  # key -> critic, of signatures run once eagerly, oldest first
        self.captured = {}  # key -> (critic, _Captured), oldest first

    def __call__(self, critic, x: torch.Tensor, options: dict):
        key = (id(critic), tuple(p.data_ptr() for p in critic.parameters()), x.shape,
               x.stride(), x.dtype, x.device, tuple(sorted(options.items())),
               torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.deterministic)
        found = self.captured.get(key)
        if found is not None:
            return found[1].replay(x)
        if self.pending.pop(key, None) is None:
            # held, so that no other critic takes its identity or addresses
            self.pending[key] = critic
            if len(self.pending) > _KEPT:
                del self.pending[next(iter(self.pending))]
            return _eager(_parts(critic, x, None, **options))
        if len(self.captured) >= _KEPT:
            del self.captured[next(iter(self.captured))]  # its graphs and pool go first
        self.captured[key] = (critic, _Captured(critic, x, options))
        return self.captured[key][1].replay(x)


_GRAPHS = _SaliencyGraphs()
