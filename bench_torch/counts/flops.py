"""Operations counted from a configuration's shapes, the same whatever
implements them (``chip_smoke.py::train_step_flops``, copied and split by
layer kind). A multiply-add is two operations. The decoder's nearest x2 +
5x5 conv pairs are counted as the 9-tap phase-split convs that compute them
exactly, as there."""

from __future__ import annotations

from typing import Dict, List, Tuple


def _encoder(cfg: Dict) -> Tuple[float, float]:
    """(conv, linear) operations of one frame's encode."""
    dims, c, k, s = cfg["encoder_dims"], cfg["channels"], cfg["vae_kernel"], cfg["frame_size"]
    convs = sum(2 * (s >> i) ** 2 * cin * cout * k * k
                for i, (cin, cout) in enumerate(zip([c] + list(dims[:-1]), dims)))
    return convs, 2 * 2 * cfg["bottleneck"] * cfg["latent_dim"]


def _decoder(cfg: Dict) -> Tuple[float, float]:
    """(conv, linear) operations of one frame's decode."""
    dims, c, k = cfg["encoder_dims"], cfg["channels"], cfg["vae_kernel"]
    start = cfg["frame_size"] >> len(dims)
    linear = 2 * (cfg["latent_dim"] + 1) * cfg["bottleneck"]
    convs = 2 * start * start * dims[3] * dims[2] * k * k
    pairs = ((dims[2], dims[1]), (dims[1], dims[0]), (dims[0], dims[0]), (dims[0], c))
    side = start
    for cin, cout in pairs:
        side *= 2
        convs += 2 * side * side * cin * cout * 9
    return convs, linear


def _critic(cfg: Dict) -> Tuple[float, float]:
    """(conv, linear) operations of one frame through the critic."""
    dims, c, k, s = cfg["critic_dims"], cfg["channels"], cfg["critic_kernel"], cfg["frame_size"]
    convs = sum(2 * (s >> i) ** 2 * cin * cout * k * k
                for i, (cin, cout) in enumerate(zip([c] + list(dims[:-1]), dims)))
    head, bott = cfg["critic_head_kernel"], cfg["critic_bottleneck"]
    convs += 2 * dims[-1] * head * head * bott
    return convs, 2 * bott * bott + 2 * bott


def _msssim(cfg: Dict) -> float:
    """One frame's MS-SSIM windows: 5 maps a scale, 2 separable passes of
    11 taps, over 5 scales."""
    s, c = cfg["frame_size"], cfg["channels"]
    return sum(5 * 2 * 11 * 2 * (s >> i) ** 2 * c for i in range(5))


def video_stages(cfg: Dict, run_crf: bool) -> List[Tuple[float, str]]:
    """(operations a frame, precision) of ``eval_episode``: the critic, the
    encoder and the two decodes (convs in TF32, cuDNN's default; linears in
    float32, torch's default for matmuls), and with the CRF the mean
    field's M @ Q, 2·N²·L a pass for ``iters`` passes, on the bf16 M."""
    conv = lin = 0.0
    for part, times in ((_critic, 1), (_encoder, 1), (_decoder, 2)):
        cv, ln = part(cfg)
        conv += times * cv
        lin += times * ln
    stages = [(conv, "tf32"), (lin, "float32")]
    if run_crf:
        n = cfg["frame_size"] ** 2
        stages.append((cfg["crf_params"][5] * 2 * n * n * cfg["crf_labels"], "bfloat16"))
    return stages


def train_step(cfg: Dict, batch: int) -> float:
    """Operations of one train step on ``batch`` frames: the VAE's forward
    three times (forward and backward), the critic's labels once, the
    MS-SSIM windows three times (``chip_smoke.py::train_step_flops``)."""
    enc, dec, crit = sum(_encoder(cfg)), sum(_decoder(cfg)), sum(_critic(cfg))
    return batch * (3 * (enc + dec) + crit + 3 * _msssim(cfg))
