"""Critic-conditioned VAE, NCHW (counterpart of
critic_vae_tpu/models/vae.py: ``encode``, ``decode``, ``reparametrize``,
``vae_apply``, ``evaluate``, ``recon_samples`` and ``inject``).

* Encoder: 4x[conv5x5 SAME -> BatchNorm (running stats) -> maxpool2 ->
  ReLU], Tanh after the last block; channel-major flatten to the bottleneck,
  then fc_mu / fc_var.
* Decoder: the critic value is concatenated onto the latent, Linear(33 ->
  bottleneck), viewed as (C, S, S), 4x[conv5x5 -> ReLU -> nearest x2], a
  last conv5x5 to 3 channels, Tanh unless ``apply_tanh=False``. By default
  (``fused=True``, as the JAX ``decode``) each nearest x2 + conv5x5 pair runs
  as the phase-split conv of ops/upconv.py; ``fused=False`` is the literal
  graph. A decoder built with ``film=True`` also holds the FiLM layers of
  the JAX package's ``film{i}`` params: per stage, (gamma, beta) =
  Linear(value), applied as x·(1 + gamma) + beta before the ReLU.

NCHW makes the JAX package's channel-major flatten/unflatten (its
transposes around the fc layers) the natural ``view``. BatchNorm runs in
float32 and casts back to the activation dtype, as the JAX package's
``_batchnorm`` does; every other layer runs in the input's dtype.

``Encoder.forward`` takes the serving options of the JAX ``encode``: the
phase-packed or space-to-depth conv+pool per block (``fused_pool``, BN per
phase before the max), BatchNorm folded into the conv (``fold_bn``), the
strided-slice pool (``pool_impl="strided"``), the float32 first conv
(``block0_f32``) and the merged front end's resume point (``start_block``).

``train=True`` runs BatchNorm on the batch's statistics (float32, over N, H
and W, normalised with the biased variance) and returns the new running
stats (momentum 0.1, the unbiased variance) beside (mu, logvar) instead of
writing them into the module: the train step commits them only when every
gradient is finite, as the JAX step does. The serving options stay
eval-only there, as in the JAX ``encode``. With ``mesh=`` (a data-parallel
mesh of ranks, parallel/mesh.py) the statistics are the global batch's,
as the JAX package's mean over axis 0 of a sharded batch: the float32 mean
and biased variance of the global batch, combined from the ranks' own, and
the running stats count the global n.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from critic_vae_tpu_torch.models.critic import conv, linear
from critic_vae_tpu_torch.ops import epilogue
from critic_vae_tpu_torch.ops.epilogue import batchnorm_eval
from critic_vae_tpu_torch.parallel.mesh import global_mean, grouped, shard_batch
from critic_vae_tpu_torch.ops.poolconv import conv_pool2_phases, s2d_conv_pool2_phases
from critic_vae_tpu_torch.ops.upconv import phase_weight, upsample2_conv5

ENCODER_DIMS = (32, 64, 128, 256)
LATENT_DIM = 32
BOTTLENECK = 4096
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
INJECT_VALUES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)  # the reference's inject ladder
POOL_IMPLS = ("reduce_window", "strided")

# ``fused_pool=True`` per block (the JAX package's FUSED_POOL_SERVING):
# space-to-depth for the 3-channel first block, the plain graph after it
FUSED_POOL_SERVING = ("s2d", False, False, False)


def batchnorm_train(bn: nn.BatchNorm2d, x: torch.Tensor, bias: torch.Tensor | None = None,
                    mesh=None):
    """Train-mode BatchNorm of the JAX ``_batchnorm(train=True)`` over NCHW
    ``x`` (``bias`` as in :func:`batchnorm_eval`): the batch's float32 mean
    and biased variance over N, H and W normalise x, which is cast back to
    its dtype. Returns (y, (new_mean, new_var)): the running stats moved by
    momentum 0.1 toward the batch mean and the unbiased variance (n/(n−1)),
    detached, and not written into ``bn``. With a grouped ``mesh`` the
    batch is the global one, each rank's ``x`` an equal share of it: the
    global mean is the mean of the ranks' means, then the global variance
    the mean over ranks of each rank's variance about its own mean plus its
    mean's squared distance from the global one (the exact combination for
    equal counts, with no E[x²] − E[x]² cancellation), and n counts every
    rank's rows. On one rank both extra terms are exactly 0, so a one-rank
    mesh computes what one process computes."""
    xf = x.float()
    if bias is not None:
        xf = xf + bias.to(x.dtype).float()[:, None, None]
    n = xf.numel() // xf.shape[1]
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    if grouped(mesh):
        local_mean = mean
        mean = global_mean(mesh, local_mean)
        var = global_mean(mesh, var + (local_mean - mean) ** 2)
        n *= mesh.size
    with torch.no_grad():
        new_mean = (1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * var * (n / max(n - 1, 1))
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * inv[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype), (new_mean, new_var)


def reparametrize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """z = mu + eps·exp(0.5·logvar) (reference: vae_nets.py:48-51). ``eps``
    takes given draws (the JAX package's threefry draws, which torch cannot
    reproduce); else they are standard normal float32 from ``generator`` on
    mu's device, cast to mu's dtype."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=torch.float32)
    return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)


def maxpool2_strided(x: torch.Tensor) -> torch.Tensor:
    """2×2 max-pool as three elementwise maxima over strided slices: the
    same candidate set as the window pool."""
    return torch.maximum(torch.maximum(x[..., ::2, ::2], x[..., ::2, 1::2]),
                         torch.maximum(x[..., 1::2, ::2], x[..., 1::2, 1::2]))



class Encoder(nn.Module):
    def __init__(self, dims=ENCODER_DIMS, channels: int = 3,
                 latent_dim: int = LATENT_DIM, bottleneck: int = BOTTLENECK):
        super().__init__()
        cins = (channels,) + tuple(dims[:-1])
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, 5, padding=2) for ci, co in zip(cins, dims)
        )
        self.bns = nn.ModuleList(nn.BatchNorm2d(co, eps=BN_EPS) for co in dims)
        self.fc_mu = nn.Linear(bottleneck, latent_dim)
        self.fc_var = nn.Linear(bottleneck, latent_dim)
        # the blocks' BN constants for the block_epilogue kernel, kept with the
        # frozen weights (ops/epilogue.py::pool_params)
        self.epilogue_cache = {}

    def forward(self, x: torch.Tensor, *, fused_pool: bool | tuple = False,
                fold_bn: bool = False, pool_impl: str = "reduce_window",
                block0_f32: bool = False, start_block: int = 0,
                downstream_dtype: torch.dtype | None = None, train: bool = False, mesh=None):
        """x (B, 3, 64, 64) -> (mu, logvar), each (B, latent); with ``train``
        (mu, logvar, stats), ``stats`` a (new_mean, new_var) per block (a
        skipped block's running stats as they are). ``mesh``: train-mode
        BatchNorm over the global batch of its ranks (:func:`batchnorm_train`);
        eval mode needs no collective.

        ``fused_pool``: ``True`` is :data:`FUSED_POOL_SERVING`; a 4-tuple
        picks per block ``False``, ``True`` (phase-packed stride-2 conv) or
        ``"s2d"``. ``fold_bn``: BN folded into the conv in float32 (w·k,
        (b − mean)·k + β) before the cast. ``pool_impl``: ``"reduce_window"``
        or ``"strided"``. ``block0_f32``: the first conv in float32, cast to
        ``downstream_dtype`` (default x's) before BN. ``start_block``: resume
        at this block with x the previous block's post-activation output."""
        if fused_pool is True:
            fused_pool = FUSED_POOL_SERVING
        elif fused_pool is False:
            fused_pool = (False,) * len(self.convs)
        if train and (any(fused_pool) or fold_bn):
            raise ValueError("encode: fused_pool/fold_bn are eval-mode serving paths")
        if pool_impl not in POOL_IMPLS:
            raise ValueError(f"unknown pool_impl {pool_impl!r}")
        pool = maxpool2_strided if pool_impl == "strided" else functools.partial(
            F.max_pool2d, kernel_size=2)
        out_dtype = x.dtype if downstream_dtype is None else downstream_dtype
        last = len(self.convs) - 1
        stats = [(bn.running_mean, bn.running_var) for bn in self.bns[:start_block]]

        def norm(bn, y, bias=None):
            if not train:
                return batchnorm_eval(bn, y, bias)
            y, new = batchnorm_train(bn, y, bias, mesh)
            stats.append(new)
            return y

        for i in range(start_block, len(self.convs)):
            layer, bn = self.convs[i], self.bns[i]
            if fused_pool[i]:
                phase_conv = (s2d_conv_pool2_phases if fused_pool[i] == "s2d"
                              else conv_pool2_phases)
                y = phase_conv(x, layer.weight.to(x.dtype))
                x = batchnorm_eval(bn, y, layer.bias).amax(dim=1)  # BN per phase, then the pool
            elif fold_bn:
                k = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
                w = layer.weight * k[:, None, None, None]
                b = (layer.bias - bn.running_mean) * k + bn.bias
                y = F.conv2d(x, w.to(x.dtype), padding=layer.padding)
                x = pool(y + b.to(x.dtype)[:, None, None])
            elif block0_f32 and i == 0:
                x = pool(norm(bn, conv(layer, x.float()).to(out_dtype)))
            else:
                y = F.conv2d(x, layer.weight.to(x.dtype), padding=layer.padding)
                if not train and pool_impl == "reduce_window":
                    x = epilogue.pool_epilogue(y, layer.bias, bn, relu=i != last,
                                               cache=self.epilogue_cache)[0]
                    x = torch.tanh(x) if i == last else x
                    continue
                x = pool(norm(bn, y, layer.bias))
            x = torch.tanh(x) if i == last else F.relu(x)
        flat = x.flatten(1)
        mu, logvar = linear(self.fc_mu, flat), linear(self.fc_var, flat)
        return (mu, logvar, stats) if train else (mu, logvar)


class Decoder(nn.Module):
    def __init__(self, dims=ENCODER_DIMS, channels: int = 3,
                 latent_dim: int = LATENT_DIM, bottleneck: int = BOTTLENECK,
                 film: bool = False):
        super().__init__()
        self.input = nn.Linear(latent_dim + 1, bottleneck)
        pairs = [(dims[3], dims[2]), (dims[2], dims[1]), (dims[1], dims[0]),
                 (dims[0], dims[0]), (dims[0], channels)]
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, 5, padding=2) for ci, co in pairs)
        # FiLM of stages 0-3: weight (2C, 1) is the JAX film{i}/w transposed
        self.film = (nn.ModuleList(nn.Linear(1, 2 * co) for _, co in pairs[:4])
                     if film else None)
        spatial = int(round((bottleneck / dims[3]) ** 0.5))
        if spatial * spatial * dims[3] != bottleneck:
            raise ValueError(
                f"decoder bottleneck {bottleneck} does not factor into "
                f"(C={dims[3]}) x S x S"
            )
        self.start_shape = (dims[3], spatial, spatial)
        # (stage, dtype) -> (the weight's identity, its phase_weight)
        self._phase_weights = {}

    def _upconv(self, i: int, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """Stage ``i``'s nearest ×2 + conv5 by phase split. Its phase weight
        in x's dtype is built once from the frozen weight, and again only when
        that weight's storage, device or in-place version changes (so a load
        or a move rebuilds it). A weight that autograd follows (training)
        gets its phase weight built in the graph, every call. ``relu``: the
        stage's ReLU, applied in its epilogue (a stage without FiLM)."""
        layer = self.convs[i]
        w = layer.weight
        if w.requires_grad and torch.is_grad_enabled():
            return upsample2_conv5(x, w, layer.bias, relu=relu)
        w4 = epilogue.frozen(self._phase_weights, (i, x.dtype), (w,),
                             lambda: phase_weight(w, x.dtype))
        return upsample2_conv5(x, w, layer.bias, w4, relu=relu)

    def _film(self, i: int, x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """Stage ``i``'s FiLM, as the JAX ``_film``: (gamma, beta) from the
        value in float32 (an elementwise product, so TF32 cannot touch it),
        cast to x's dtype, then x·(1 + gamma) + beta in that dtype."""
        if self.film is None:
            return x
        layer = self.film[i]
        gb = value.float()[:, None] * layer.weight[:, 0] + layer.bias
        gamma, beta = gb.to(x.dtype)[..., None, None].chunk(2, dim=1)
        return x * (1 + gamma) + beta

    def forward(self, z: torch.Tensor, value: torch.Tensor, apply_tanh: bool = True,
                fused: bool = True) -> torch.Tensor:
        """z (B, latent), value (B,) -> (B, 3, 64, 64), pre-tanh unless
        ``apply_tanh``. ``fused``: the phase-split upsample+conv (the JAX
        default), else the literal repeat-then-conv graph."""
        value = value.reshape(-1)
        zin = torch.cat([z, value[:, None].to(z.dtype)], dim=1)
        x = linear(self.input, zin).view(z.shape[0], *self.start_shape)
        if fused:
            x = F.relu(self._film(0, conv(self.convs[0], x), value))
            for i in (1, 2, 3):
                if self.film is None:
                    x = self._upconv(i, x, relu=True)
                else:
                    x = F.relu(self._film(i, self._upconv(i, x), value))
            x = self._upconv(len(self.convs) - 1, x)
        else:
            for i, layer in enumerate(self.convs[:-1]):
                x = F.relu(self._film(i, conv(layer, x), value))
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = conv(self.convs[-1], x)
        return torch.tanh(x) if apply_tanh else x


class VAE(nn.Module):
    def __init__(self, dims=ENCODER_DIMS, channels: int = 3,
                 latent_dim: int = LATENT_DIM, bottleneck: int = BOTTLENECK,
                 film: bool = False):
        super().__init__()
        self.encoder = Encoder(dims, channels, latent_dim, bottleneck)
        self.decoder = Decoder(dims, channels, latent_dim, bottleneck, film=film)

    def encode(self, x: torch.Tensor, **options):
        """(mu, logvar); ``options`` are :meth:`Encoder.forward`'s."""
        return self.encoder(x, **options)

    def decode(self, z: torch.Tensor, value: torch.Tensor, apply_tanh: bool = True,
               fused: bool = True) -> torch.Tensor:
        return self.decoder(z, value, apply_tanh, fused)

    def vae_apply(self, x: torch.Tensor, value: torch.Tensor, *,
                  eps: torch.Tensor | None = None, generator: torch.Generator | None = None,
                  mesh=None):
        """The stochastic forward of training (reference: vae_nets.py:14-19):
        (recon, mu, logvar, stats), ``stats`` the new running stats of the
        train-mode encode; ``eps`` and ``generator`` as :func:`reparametrize`.
        With a grouped ``mesh`` x is this rank's share of the global batch:
        BatchNorm takes the global statistics, and without ``eps`` the rank
        draws the global batch's noise and takes its rows, so each frame
        gets one process's draw and the generator moves alike on every
        rank."""
        mu, logvar, stats = self.encode(x, train=True, mesh=mesh)
        if eps is None and grouped(mesh):
            eps = shard_batch(mesh, torch.randn((mu.shape[0] * mesh.size, mu.shape[1]),
                                                generator=generator, device=mu.device,
                                                dtype=torch.float32))
        z = reparametrize(mu, logvar, eps, generator)
        return self.decode(z, value), mu, logvar, stats

    def evaluate(self, x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """The deterministic mu-decode (reference: vae_nets.py:42-46)."""
        return self.decode(self.encode(x)[0], value)

    def recon_samples(self, x: torch.Tensor, value, n_samples: int = 6, *,
                      eps: torch.Tensor | None = None,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """``n_samples`` stochastic reconstructions of each frame at one
        injected value (a scalar or one a frame), as one batched decode of
        B·n latents: (B, n, 3, H, W). ``eps`` (B·n, latent) as
        :func:`reparametrize`."""
        mu, logvar = self.encode(x)
        b = mu.shape[0]
        value = torch.as_tensor(value, dtype=torch.float32, device=mu.device).reshape(-1).expand(b)
        z = reparametrize(mu.repeat_interleave(n_samples, 0),
                          logvar.repeat_interleave(n_samples, 0), eps, generator)
        recon = self.decode(z, value.repeat_interleave(n_samples, 0))
        return recon.view(b, n_samples, *recon.shape[1:])

    def inject(self, x: torch.Tensor, values: torch.Tensor | None = None) -> torch.Tensor:
        """Each frame's mu decoded at a ladder of injected critic values
        (default :data:`INJECT_VALUES`), as one batched decode of B·K
        latents: (B, K, 3, H, W)."""
        mu = self.encode(x)[0]
        if values is None:
            values = INJECT_VALUES
        values = torch.as_tensor(values, dtype=torch.float32, device=mu.device)
        b, k = mu.shape[0], values.shape[0]
        recon = self.decode(mu.repeat_interleave(k, 0), values.repeat(b))
        return recon.view(b, k, *recon.shape[1:])
