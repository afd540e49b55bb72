"""Seeded weights of the reference's critic and VAE, made on the device.

The shapes and bounds are those of the port's ``io/weights.py``
``numpy_critic_params`` and ``numpy_vae_params`` (copied from there: torch's
default uniform init, bound 1/sqrt(fan_in), BatchNorm's scale 1 and bias 0,
running mean 0 and variance 1), but drawn in one call from a
``torch.Generator`` on the device seeded with ``--seed``, in float32, the
type both configurations serve and train in. The tensors are in torch's
layouts (OIHW convs, (out, in) linears), keyed by the port's
``state_dict`` names, which the plain reference reads too.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Shapes = List[Tuple[str, Tuple[int, ...], int]]


def critic_shapes(cfg: Dict) -> Shapes:
    """(name, shape, fan_in) of every drawn critic leaf."""
    dims, c, bott = cfg["critic_dims"], cfg["channels"], cfg["critic_bottleneck"]
    k = cfg["critic_kernel"]
    out: Shapes = []
    cin = c
    for i, cout in enumerate(dims):
        out += [(f"convs.{i}.weight", (cout, cin, k, k), cin * k * k),
                (f"convs.{i}.bias", (cout,), cin * k * k)]
        cin = cout
    head = cfg["critic_head_kernel"]
    out += [("conv4.weight", (bott, dims[-1], head, head), dims[-1] * head * head),
            ("conv4.bias", (bott,), dims[-1] * head * head),
            ("fc0.weight", (bott, bott), bott), ("fc0.bias", (bott,), bott),
            ("fc1.weight", (1, bott), bott), ("fc1.bias", (1,), bott)]
    return out


def vae_shapes(cfg: Dict) -> Shapes:
    """(name, shape, fan_in) of every drawn VAE leaf."""
    dims, c, k = cfg["encoder_dims"], cfg["channels"], cfg["vae_kernel"]
    latent, bott = cfg["latent_dim"], cfg["bottleneck"]
    out: Shapes = []
    cin = c
    for i, cout in enumerate(dims):
        out += [(f"encoder.convs.{i}.weight", (cout, cin, k, k), cin * k * k),
                (f"encoder.convs.{i}.bias", (cout,), cin * k * k)]
        cin = cout
    for head in ("fc_mu", "fc_var"):
        out += [(f"encoder.{head}.weight", (latent, bott), bott),
                (f"encoder.{head}.bias", (latent,), bott)]
    out += [("decoder.input.weight", (bott, latent + 1), latent + 1),
            ("decoder.input.bias", (bott,), latent + 1)]
    pairs = [(dims[3], dims[2]), (dims[2], dims[1]), (dims[1], dims[0]), (dims[0], dims[0]),
             (dims[0], c)]
    for i, (ci, co) in enumerate(pairs):
        out += [(f"decoder.convs.{i}.weight", (co, ci, k, k), ci * k * k),
                (f"decoder.convs.{i}.bias", (co,), ci * k * k)]
    return out


def make(cfg: Dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(critic, vae) state dicts drawn from ``seed`` on ``device``: one
    uniform draw for every leaf of both nets, each leaf scaled by its bound;
    BatchNorm's scale, bias and running statistics as freshly built."""
    shapes = [("critic", *s) for s in critic_shapes(cfg)] + [("vae", *s) for s in vae_shapes(cfg)]
    sizes = [int(torch.Size(shape).numel()) for _, _, shape, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat = flat * 2.0 - 1.0
    nets: Dict[str, Dict[str, torch.Tensor]] = {"critic": {}, "vae": {}}
    for (net, name, shape, fan_in), part in zip(shapes, flat.split(sizes)):
        nets[net][name] = (part * fan_in ** -0.5).view(shape)
    for i, cout in enumerate(cfg["encoder_dims"]):
        def const(v):
            return torch.full((cout,), v, dtype=torch.float32, device=device)

        nets["vae"].update({f"encoder.bns.{i}.weight": const(1.0),
                            f"encoder.bns.{i}.bias": const(0.0),
                            f"encoder.bns.{i}.running_mean": const(0.0),
                            f"encoder.bns.{i}.running_var": const(1.0)})
    return nets["critic"], nets["vae"]


def jax_layout(cfg: Dict, vae: Dict[str, torch.Tensor]):
    """The VAE as the JAX-layout numpy ``(params, bn_state)`` that the port's
    ``train/step.py::init_train_state`` takes (HWIO convs, (in, out)
    linears)."""
    def n(t):
        return t.detach().cpu().numpy()

    def conv(prefix):
        return {"w": n(vae[f"{prefix}.weight"].permute(2, 3, 1, 0)), "b": n(vae[f"{prefix}.bias"])}

    def lin(prefix):
        return {"w": n(vae[f"{prefix}.weight"].t()), "b": n(vae[f"{prefix}.bias"])}

    enc, state = {}, {}
    for i in range(len(cfg["encoder_dims"])):
        enc[f"conv{i}"] = conv(f"encoder.convs.{i}")
        enc[f"bn{i}"] = {"scale": n(vae[f"encoder.bns.{i}.weight"]),
                         "bias": n(vae[f"encoder.bns.{i}.bias"])}
        state[f"bn{i}"] = {"mean": n(vae[f"encoder.bns.{i}.running_mean"]),
                           "var": n(vae[f"encoder.bns.{i}.running_var"])}
    enc["fc_mu"], enc["fc_var"] = lin("encoder.fc_mu"), lin("encoder.fc_var")
    dec = {"input": lin("decoder.input")}
    for i in range(5):
        dec[f"conv{i}"] = conv(f"decoder.convs.{i}")
    return {"encoder": enc, "decoder": dec}, state


def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy ``sd`` into ``module`` (every key of the module's state but
    BatchNorm's step counters), and refuse a module whose names or shapes
    differ."""
    own = {k: v for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}
    if set(own) != set(sd):
        raise RuntimeError(f"state names differ: module-only {sorted(set(own) - set(sd))}, "
                           f"harness-only {sorted(set(sd) - set(own))}")
    with torch.no_grad():
        for k, v in own.items():
            if tuple(v.shape) != tuple(sd[k].shape):
                raise RuntimeError(f"{k}: module {tuple(v.shape)}, harness {tuple(sd[k].shape)}")
            v.copy_(sd[k])


def same_state(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> bool:
    """Whether ``module`` holds exactly ``sd`` (BatchNorm's counters aside)."""
    own = {k: v for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}
    return set(own) == set(sd) and all(torch.equal(v, sd[k].to(v.device)) for k, v in own.items())


def _standardise(sd: Dict[str, torch.Tensor], prefix: str, y: torch.Tensor, std: float = 1.0):
    """Rescale layer ``prefix`` so that its output ``y`` (channels on dim 1)
    has mean 0 and standard deviation ``std`` per channel over the batch;
    returns the rescaled output."""
    dims = [d for d in range(y.dim()) if d != 1]
    mean, sd_y = y.mean(dim=dims), y.std(dim=dims) + 1e-6
    w = sd[f"{prefix}.weight"]
    scale = std / sd_y
    sd[f"{prefix}.weight"] = w * scale.view(-1, *([1] * (w.dim() - 1)))
    sd[f"{prefix}.bias"] = (sd[f"{prefix}.bias"] - mean) * scale
    shape = [1] * y.dim()
    shape[1] = -1
    return (y - mean.view(shape)) * scale.view(shape)


@torch.no_grad()
def calibrate(cfg: Dict, critic: Dict[str, torch.Tensor], vae: Dict[str, torch.Tensor],
              frames_u8: torch.Tensor) -> None:
    """Data-dependent initialisation of seeded weights (as LSUV, Mishkin and
    Matas 2016, does it), in place, on (B, H, W, 3) uint8 frames, in
    float32 with TF32 off: every critic layer's and decoder layer's output,
    and the encoder's mu, standardised per channel over the batch, and the
    encoder's BatchNorm running statistics set to the batch's. So the
    critic's scores spread over (0, 1) and the masks follow each frame, as a
    trained model's do, where freshly drawn weights score every frame alike
    and decode one pattern for all."""
    from bench_torch.reference import exact_float32

    with exact_float32():
        x = frames_u8.float().permute(0, 3, 1, 2) / 255.0
        h = x
        for i in range(len(cfg["critic_dims"])):
            w = critic[f"convs.{i}.weight"]
            y = F.conv2d(h, w, critic[f"convs.{i}.bias"], padding=w.shape[-1] // 2)
            h = F.max_pool2d(F.relu(_standardise(critic, f"convs.{i}", y)), 2)
        y = F.conv2d(h, critic["conv4.weight"], critic["conv4.bias"])
        h = F.relu(_standardise(critic, "conv4", y)).flatten(1)
        y = F.linear(h, critic["fc0.weight"], critic["fc0.bias"])
        h = F.relu(_standardise(critic, "fc0", y))
        logits = _standardise(critic, "fc1", F.linear(h, critic["fc1.weight"], critic["fc1.bias"]))
        preds = torch.sigmoid(logits)[:, 0]
        h = x
        dims = cfg["encoder_dims"]
        for i in range(len(dims)):
            w = vae[f"encoder.convs.{i}.weight"]
            y = F.conv2d(h, w, vae[f"encoder.convs.{i}.bias"], padding=w.shape[-1] // 2)
            mean, var = y.mean(dim=(0, 2, 3)), y.var(dim=(0, 2, 3))
            vae[f"encoder.bns.{i}.running_mean"], vae[f"encoder.bns.{i}.running_var"] = mean, var
            y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + cfg.get("bn_eps", 1e-5))
            y = F.max_pool2d(y, 2)
            h = torch.tanh(y) if i == len(dims) - 1 else F.relu(y)
        flat = h.flatten(1)
        mu = _standardise(vae, "encoder.fc_mu",
                          F.linear(flat, vae["encoder.fc_mu.weight"], vae["encoder.fc_mu.bias"]))
        y = F.linear(torch.cat([mu, preds[:, None]], dim=1), vae["decoder.input.weight"],
                     vae["decoder.input.bias"])
        y = _standardise(vae, "decoder.input", y)
        side = int(round((y.shape[1] / dims[-1]) ** 0.5))
        h = y.view(-1, dims[-1], side, side)
        for i in range(5):
            if i:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            w = vae[f"decoder.convs.{i}.weight"]
            y = F.conv2d(h, w, vae[f"decoder.convs.{i}.bias"], padding=w.shape[-1] // 2)
            h = _standardise(vae, f"decoder.convs.{i}", y)
            if i < 4:
                h = F.relu(h)
