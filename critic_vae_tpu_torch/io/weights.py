"""Weight bridge: the JAX package's parameter pytrees (as numpy arrays) to
and from the port's modules, with numpy alone.

JAX layouts: convs HWIO, linears (in, out), BatchNorm as ``scale``/``bias``
params plus ``mean``/``var`` running stats in a separate state tree
(critic_vae_tpu/models/critic.py, models/vae.py). The port's modules hold
torch layouts: convs OIHW, linears (out, in).

Files:

* a critic ``.npz`` is the JAX package's flat format (``conv0_w`` ...,
  ``saved-networks/critic-synthetic.npz``); any other critic file is the
  reference's torch state dict (``.pt``, zip or legacy format), read by
  ``torch.load(weights_only=True)`` (:func:`load_critic`);
* the JAX package's ``train`` artifacts, the encoder's ``{params, bn_state}``
  and the decoder's ``{params}`` written by its ``io/checkpoint.save_pytree``
  (zip files of ``<path>.npy`` entries, '/'-joined pytree paths, named
  ``*.ckpt``): :func:`load_final_weights`, strict as ``io/checkpoint.py``'s
  ``load_pytree``;
* a combined VAE ``.npz`` holds ``params/<encoder|decoder>/<layer>/<leaf>``
  and ``bn_state/bn<i>/<mean|var>``, the same key scheme applied to
  ``{"params": params, "bn_state": state}``.

A decoder whose params hold ``film{i}`` (the JAX package's ``train --film``)
builds a FiLM decoder.

Export (the JAX package's ``export``): :func:`critic_state_dict_to_torch`
and :func:`vae_state_dicts_to_torch` give the reference's torch
``state_dict`` layouts as numpy arrays; a FiLM decoder has no counterpart
there and is refused.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.io.checkpoint import flatten, load_pytree, unflatten
from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import BOTTLENECK, ENCODER_DIMS, LATENT_DIM, VAE

Params = Dict[str, object]
SYNTHETIC_CRITIC = Path(__file__).resolve().parents[2] / "saved-networks" / "critic-synthetic.npz"


def _hwio_to_oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _oihw_to_hwio(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w.detach().cpu().numpy(), (2, 3, 1, 0)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _set_conv(layer, p_w, p_b) -> None:
    layer.weight.data.copy_(_hwio_to_oihw(p_w))
    layer.bias.data.copy_(_t(p_b))


def _set_linear(layer, p_w, p_b) -> None:
    layer.weight.data.copy_(_t(np.asarray(p_w).T))
    layer.bias.data.copy_(_t(p_b))


# --------------------------------------------------------------------- critic


def load_critic_npz(path: str) -> Dict[str, np.ndarray]:
    """The JAX package's flat critic ``.npz`` as a dict of numpy arrays."""
    with np.load(path) as data:
        return {k: np.asarray(v) for k, v in data.items()}


def critic_from_params(params: Dict[str, np.ndarray]) -> Critic:
    dims = tuple(int(np.shape(params[f"conv{i}_w"])[-1]) for i in range(4))
    critic = Critic(dims, bottleneck=int(np.shape(params["conv4_w"])[-1]),
                    channels=int(np.shape(params["conv0_w"])[2]))
    for i, layer in enumerate(critic.convs):
        _set_conv(layer, params[f"conv{i}_w"], params[f"conv{i}_b"])
    _set_conv(critic.conv4, params["conv4_w"], params["conv4_b"])
    _set_linear(critic.fc0, params["fc0_w"], params["fc0_b"])
    _set_linear(critic.fc1, params["fc1_w"], params["fc1_b"])
    return critic.eval().requires_grad_(False)


def critic_params_from_torch(state_dict) -> Dict[str, np.ndarray]:
    """A torch critic state dict (OIHW convs, (out, in) linears) -> the JAX
    flat layout, by the reference's module indices (critic_net.py:15-42):
    features.{0,3,6,10,14} are the convs, crit.{1,4} the linears (the JAX
    package's ``critic_params_from_torch``)."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    params: Dict[str, np.ndarray] = {}
    for i, key in enumerate(("features.0", "features.3", "features.6", "features.10")):
        params[f"conv{i}_w"] = np.transpose(sd[f"{key}.weight"], (2, 3, 1, 0))
        params[f"conv{i}_b"] = sd[f"{key}.bias"]
    params["conv4_w"] = np.transpose(sd["features.14.weight"], (2, 3, 1, 0))
    params["conv4_b"] = sd["features.14.bias"]
    params["fc0_w"] = sd["crit.1.weight"].T
    params["fc0_b"] = sd["crit.1.bias"]
    params["fc1_w"] = sd["crit.4.weight"].T
    params["fc1_b"] = sd["crit.4.bias"]
    return params


def load_critic(path: str) -> Dict[str, np.ndarray]:
    """A critic checkpoint as JAX-layout numpy params: ``.npz`` is the JAX
    package's flat format; anything else is a torch state dict, zip or
    legacy format, read with ``torch.load(weights_only=True)`` (tensors and
    plain containers only) and mapped by :func:`critic_params_from_torch`."""
    if str(path).endswith(".npz"):
        return load_critic_npz(path)
    return critic_params_from_torch(torch.load(path, map_location="cpu", weights_only=True))


def numpy_critic_params(seed: int, dims=(8, 8, 8, 16), bottleneck: int = 32,
                        channels: int = 3) -> Dict[str, np.ndarray]:
    """Fresh critic params in the JAX flat layout, made with numpy from
    ``seed``: the shapes and torch-default uniform bounds (1/sqrt(fan_in))
    of ``critic_vae_tpu.models.critic.init_critic_params``, drawn from
    ``np.random.default_rng(seed)`` in its key order, not from threefry."""
    rng = np.random.default_rng(seed)

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    params: Dict[str, np.ndarray] = {}
    cin = channels
    for i, cout in enumerate(dims):
        params[f"conv{i}_w"] = uniform((3, 3, cin, cout), cin * 9)
        params[f"conv{i}_b"] = uniform((cout,), cin * 9)
        cin = cout
    params["conv4_w"] = uniform((4, 4, dims[3], bottleneck), dims[3] * 16)
    params["conv4_b"] = uniform((bottleneck,), dims[3] * 16)
    params["fc0_w"] = uniform((bottleneck, bottleneck), bottleneck)
    params["fc0_b"] = uniform((bottleneck,), bottleneck)
    params["fc1_w"] = uniform((bottleneck, 1), bottleneck)
    params["fc1_b"] = uniform((1,), bottleneck)
    return params


def save_critic(path: str, params: Dict[str, np.ndarray]) -> None:
    """A critic as the JAX package's flat ``.npz`` (its ``save_critic``),
    which its ``load_critic`` and :func:`load_critic` read."""
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def critic_state_dict_to_torch(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`critic_params_from_torch`: the reference's critic
    ``state_dict`` layout (OIHW convs, (out, in) linears) as numpy arrays."""
    sd: Dict[str, np.ndarray] = {}
    for i, key in enumerate(("features.0", "features.3", "features.6", "features.10")):
        sd[f"{key}.weight"] = np.transpose(np.asarray(params[f"conv{i}_w"]), (3, 2, 0, 1)).copy()
        sd[f"{key}.bias"] = np.asarray(params[f"conv{i}_b"])
    sd["features.14.weight"] = np.transpose(np.asarray(params["conv4_w"]), (3, 2, 0, 1)).copy()
    sd["features.14.bias"] = np.asarray(params["conv4_b"])
    sd["crit.1.weight"] = np.ascontiguousarray(np.asarray(params["fc0_w"]).T)
    sd["crit.1.bias"] = np.asarray(params["fc0_b"])
    sd["crit.4.weight"] = np.ascontiguousarray(np.asarray(params["fc1_w"]).T)
    sd["crit.4.bias"] = np.asarray(params["fc1_b"])
    return sd


def critic_to_params(critic: Critic) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(critic.convs):
        out[f"conv{i}_w"], out[f"conv{i}_b"] = _oihw_to_hwio(layer.weight), _n(layer.bias)
    out["conv4_w"], out["conv4_b"] = _oihw_to_hwio(critic.conv4.weight), _n(critic.conv4.bias)
    for name in ("fc0", "fc1"):
        layer = getattr(critic, name)
        out[f"{name}_w"] = np.ascontiguousarray(_n(layer.weight).T)
        out[f"{name}_b"] = _n(layer.bias)
    return out


# ------------------------------------------------------------------------ VAE


def numpy_vae_params(
    seed: int, dims: Tuple[int, ...] = ENCODER_DIMS, channels: int = 3,
    latent_dim: int = LATENT_DIM, bottleneck: int = BOTTLENECK, film: bool = False,
) -> Tuple[Params, Params]:
    """A JAX-layout VAE ``(params, bn_state)`` made with numpy from ``seed``.

    Same structure, shapes, dtypes and torch-default uniform bounds
    (1/sqrt(fan_in)) as ``critic_vae_tpu.models.vae.init_vae_params``, but
    drawn from ``np.random.default_rng(seed)``: the repo holds no trained
    VAE, and a machine without jax can still build these weights, so tests
    and the card feed the same numpy tree to both packages. ``film=True``
    adds the zero FiLM params ``film{i}`` of stages 0-3, shaped as
    ``init_vae_params(film=True)`` shapes them (w (1, 2C), b (2C,)); the
    other draws are those of ``film=False``."""
    rng = np.random.default_rng(seed)

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def conv(cin, cout):
        return {"w": uniform((5, 5, cin, cout), cin * 25),
                "b": uniform((cout,), cin * 25)}

    def lin(cin, cout):
        return {"w": uniform((cin, cout), cin), "b": uniform((cout,), cin)}

    enc: Params = {}
    cin = channels
    for i, cout in enumerate(dims):
        enc[f"conv{i}"] = conv(cin, cout)
        enc[f"bn{i}"] = {"scale": np.ones((cout,), np.float32),
                         "bias": np.zeros((cout,), np.float32)}
        cin = cout
    enc["fc_mu"] = lin(bottleneck, latent_dim)
    enc["fc_var"] = lin(bottleneck, latent_dim)
    dec: Params = {"input": lin(latent_dim + 1, bottleneck)}
    pairs = [(dims[3], dims[2]), (dims[2], dims[1]), (dims[1], dims[0]),
             (dims[0], dims[0]), (dims[0], channels)]
    for i, (ci, co) in enumerate(pairs):
        dec[f"conv{i}"] = conv(ci, co)
    if film:
        for i, (_, co) in enumerate(pairs[:4]):
            dec[f"film{i}"] = {"w": np.zeros((1, 2 * co), np.float32),
                               "b": np.zeros((2 * co,), np.float32)}
    state = {f"bn{i}": {"mean": np.zeros((c,), np.float32),
                        "var": np.ones((c,), np.float32)}
             for i, c in enumerate(dims)}
    return {"encoder": enc, "decoder": dec}, state


def vae_from_params(params: Params, state: Params) -> VAE:
    """The port's VAE holding the JAX-layout ``(params, bn_state)``; a FiLM
    decoder when the decoder's params hold ``film{i}``."""
    enc, dec = params["encoder"], params["decoder"]
    dims = tuple(int(np.shape(enc[f"conv{i}"]["w"])[-1]) for i in range(4))
    latent_dim, bottleneck = (int(s) for s in np.shape(enc["fc_mu"]["w"])[::-1])
    vae = VAE(dims, channels=int(np.shape(enc["conv0"]["w"])[2]),
              latent_dim=latent_dim, bottleneck=bottleneck, film="film0" in dec)
    for i, (layer, bn) in enumerate(zip(vae.encoder.convs, vae.encoder.bns)):
        _set_conv(layer, enc[f"conv{i}"]["w"], enc[f"conv{i}"]["b"])
        bn.weight.data.copy_(_t(enc[f"bn{i}"]["scale"]))
        bn.bias.data.copy_(_t(enc[f"bn{i}"]["bias"]))
        bn.running_mean.copy_(_t(state[f"bn{i}"]["mean"]))
        bn.running_var.copy_(_t(state[f"bn{i}"]["var"]))
    _set_linear(vae.encoder.fc_mu, enc["fc_mu"]["w"], enc["fc_mu"]["b"])
    _set_linear(vae.encoder.fc_var, enc["fc_var"]["w"], enc["fc_var"]["b"])
    _set_linear(vae.decoder.input, dec["input"]["w"], dec["input"]["b"])
    for i, layer in enumerate(vae.decoder.convs):
        _set_conv(layer, dec[f"conv{i}"]["w"], dec[f"conv{i}"]["b"])
    for i, layer in enumerate(vae.decoder.film or ()):
        _set_linear(layer, dec[f"film{i}"]["w"], dec[f"film{i}"]["b"])
    return vae.eval().requires_grad_(False)


def synthetic_models(device) -> Tuple[Critic, VAE]:
    """The full-width critic of ``saved-networks/critic-synthetic.npz`` and
    the ``numpy_vae_params(0)`` VAE, on ``device``."""
    critic = critic_from_params(load_critic_npz(str(SYNTHETIC_CRITIC)))
    return critic.to(device), vae_from_params(*numpy_vae_params(0)).to(device)


def vae_to_params(vae: VAE) -> Tuple[Params, Params]:
    enc: Params = {}
    state: Params = {}
    for i, (layer, bn) in enumerate(zip(vae.encoder.convs, vae.encoder.bns)):
        enc[f"conv{i}"] = {"w": _oihw_to_hwio(layer.weight), "b": _n(layer.bias)}
        enc[f"bn{i}"] = {"scale": _n(bn.weight), "bias": _n(bn.bias)}
        state[f"bn{i}"] = {"mean": _n(bn.running_mean), "var": _n(bn.running_var)}
    for name in ("fc_mu", "fc_var"):
        layer = getattr(vae.encoder, name)
        enc[name] = {"w": np.ascontiguousarray(_n(layer.weight).T), "b": _n(layer.bias)}
    dec: Params = {"input": {"w": np.ascontiguousarray(_n(vae.decoder.input.weight).T),
                             "b": _n(vae.decoder.input.bias)}}
    for i, layer in enumerate(vae.decoder.convs):
        dec[f"conv{i}"] = {"w": _oihw_to_hwio(layer.weight), "b": _n(layer.bias)}
    for i, layer in enumerate(vae.decoder.film or ()):
        dec[f"film{i}"] = {"w": np.ascontiguousarray(_n(layer.weight).T), "b": _n(layer.bias)}
    return {"encoder": enc, "decoder": dec}, state


def load_final_weights(encoder_path: str, decoder_path: str) -> Tuple[Params, Params]:
    """``(params, bn_state)`` from the JAX package's separate encoder and
    decoder artifacts (its ``pipelines/train.py::load_final_weights``, as
    its ``video`` calls it: the full-width model's structure).

    A missing or extra leaf, or a wrong shape or dtype, raises. FiLM
    decoders are detected from ``params/film*`` keys in the decoder's file
    and added to the structure with the stored shapes and dtypes."""
    like_params, like_bn = numpy_vae_params(0)
    like_dec = dict(like_params["decoder"])
    with np.load(decoder_path) as stored:
        for k in stored.files:
            if k.startswith("params/film"):
                name, leaf = k[len("params/"):].split("/")
                like_dec.setdefault(name, {})[leaf] = np.zeros(stored[k].shape, stored[k].dtype)
    enc = load_pytree(encoder_path, {"params": like_params["encoder"], "bn_state": like_bn})
    dec = load_pytree(decoder_path, {"params": like_dec})
    return {"encoder": enc["params"], "decoder": dec["params"]}, enc["bn_state"]


def vae_state_dicts_to_torch(params: Params, state: Params
                             ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """JAX-layout ``(params, bn_state)`` -> the reference's encoder and
    decoder ``state_dict`` layouts (OIHW convs, (out, in) linears, BatchNorm
    running stats and ``num_batches_tracked``), as the JAX package's
    ``vae_state_dicts_to_torch``; a FiLM decoder raises its ValueError."""
    film_keys = [k for k in params["decoder"] if k.startswith("film")]
    if film_keys:
        raise ValueError(
            f"decoder carries FiLM conditioning params {sorted(film_keys)}; "
            "the torch reference architecture (vae_nets.py:116-147) cannot "
            "represent them — export only non-film models"
        )

    def conv(p):
        return np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)).copy(), np.asarray(p["b"])

    def linear(p):
        return np.ascontiguousarray(np.asarray(p["w"]).T), np.asarray(p["b"])

    enc, enc_sd = params["encoder"], {}
    for i, idx in enumerate((0, 4, 8, 12)):
        enc_sd[f"model.{idx}.weight"], enc_sd[f"model.{idx}.bias"] = conv(enc[f"conv{i}"])
        bn = f"model.{idx + 1}"
        enc_sd[f"{bn}.weight"] = np.asarray(enc[f"bn{i}"]["scale"])
        enc_sd[f"{bn}.bias"] = np.asarray(enc[f"bn{i}"]["bias"])
        enc_sd[f"{bn}.running_mean"] = np.asarray(state[f"bn{i}"]["mean"])
        enc_sd[f"{bn}.running_var"] = np.asarray(state[f"bn{i}"]["var"])
        enc_sd[f"{bn}.num_batches_tracked"] = np.asarray(0, np.int64)
    for name in ("fc_mu", "fc_var"):
        enc_sd[f"{name}.weight"], enc_sd[f"{name}.bias"] = linear(enc[name])
    dec = params["decoder"]
    dec_sd: Dict[str, np.ndarray] = {}
    dec_sd["decoder_input.weight"], dec_sd["decoder_input.bias"] = linear(dec["input"])
    for i, idx in enumerate((0, 3, 6, 9, 12)):
        dec_sd[f"model.{idx}.weight"], dec_sd[f"model.{idx}.bias"] = conv(dec[f"conv{i}"])
    return enc_sd, dec_sd


def save_state_dict_pt(path: str, state_dict: Dict[str, np.ndarray]) -> None:
    """A numpy ``state_dict`` as a torch ``.pt`` (``torch.save``, zip
    format) of CPU tensors, which ``torch.load(weights_only=True)`` and the
    JAX package's ``io/legacy_pt.py::load_torch_pt`` read."""
    # np.array, not np.ascontiguousarray, which makes a 0-d array (1,)
    torch.save({k: torch.from_numpy(np.array(v, order="C")) for k, v in state_dict.items()}, path)


def save_vae_npz(path: str, params: Params, state: Params) -> None:
    np.savez(path, **flatten({"params": params, "bn_state": state}))


def load_vae_npz(path: str) -> Tuple[Params, Params]:
    """``(params, bn_state)`` numpy trees from a VAE ``.npz`` (see module doc)."""
    with np.load(path) as data:
        tree = unflatten({k: np.asarray(data[k]) for k in data.files})
    if set(tree) != {"params", "bn_state"}:
        raise ValueError(f"{path}: expected top-level params/ and bn_state/ keys, got {sorted(tree)}")
    return tree["params"], tree["bn_state"]
