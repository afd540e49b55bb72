"""Probe P2: the fused front-end kernel on Hopper, and its copy floor.

Counterpart of examples/mosaic_copy_floor_probe.py, at its shapes: B = 1024
frames, F frames per block (``PROBE_F``, default 4: the frames a block takes
at a time; the grid is about one block an SM), x (B·1156, 12) bf16 — each
frame's space-to-depth input, (34, 34, 12) scanline rows — w (128, 160)
bf16, output (B·1024, 40) bf16. The kernel (``csrc/front_end_probe.cu``)
brings whole frames into shared memory with bulk async copies and reads
each output row's im2col operand straight from the frame's scanlines, with
no slab: one ``wgmma`` (2 frames × 32 columns, 112) @ (112, 160) product a
row, keeping only ReLU of the max over the four 40-column phase groups.
``dot_only`` runs it on zeroed frames without the copies; the difference of
the two times is the copy floor.

With x the space-to-depth of padded frames and w ``s2d_pool_weights`` of the
merged 3→40 first-conv weights as (108, 160) rows, zero-padded to 128, the
output is ReLU of the pool-phase max of ``s2d_conv_pool2_phases``: the
pooled merged front end before its biases (:func:`pack_frames`,
:func:`pack_weights`).

The record also holds, at the same B in bf16 from NCHW frames:

* ``fused_path_ms``: the s2d packing of the frames plus the kernel;
* ``library_path_ms``: the same function by library calls, the s2d packing,
  cuDNN's 3×3 s2d conv, the phase max and ReLU (:func:`library_front_end`);
* ``cudnn_front_end_ms``: the port's merged front end (ops/mask.py
  ``merged_front_end``), which does more: the 3→40 conv at full resolution,
  both branches' biases, the encoder's BN in float32, two pools and ReLUs.

Run:  python -m critic_vae_tpu_torch.probes.copy_floor_probe [OUT_JSON]
          [--device cuda|cpu] [--frames B]
``--device cpu`` runs the plain versions and measures no time.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.device import cuda_ms, resolve_device
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.ops.poolconv import (
    s2d_conv_pool2_phases,
    s2d_pool_weights,
    space_to_depth2,
)

FRAMES = 1024
S2D_SIDE = 34
S2D_ROWS = S2D_SIDE * S2D_SIDE
S2D_C = 12
OUT_SIDE = 32
OUT_ROWS = OUT_SIDE * OUT_SIDE
K, N, PHASE_C = 128, 160, 40
PATCH = 9 * S2D_C  # 108 im2col columns; w's rows 108..127 meet zeros
K_PAD = 112        # PATCH padded to whole wgmma k-steps of 16
DEFAULT_FRAMES_PER_BLOCK = 4
RING = 3             # frame-pair buffers of a block
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def smem_bytes() -> int:
    """Shared memory of one block: w (K_PAD, N) bf16, a ring of RING frame
    pairs, and two 8-byte mbarriers a pair buffer."""
    return K_PAD * N * 2 + RING * (2 * S2D_ROWS * S2D_C * 2 + 16)


def im2col_rows(frames: int, device) -> torch.Tensor:
    """(frames·1024, 9) x-row indices: for pooled pixel (i, j) of frame b
    and tap (r, t), row 1156 b + 34 (i + r) + t + j."""
    b = torch.arange(frames, device=device)[:, None, None, None, None]
    i = torch.arange(OUT_SIDE, device=device)[None, :, None, None, None]
    j = torch.arange(OUT_SIDE, device=device)[None, None, :, None, None]
    r = torch.arange(3, device=device)[None, None, None, :, None]
    t = torch.arange(3, device=device)[None, None, None, None, :]
    return (S2D_ROWS * b + S2D_SIDE * (i + r) + t + j).reshape(frames * OUT_ROWS, 9)


def front_end_probe_reference(x: torch.Tensor, w: torch.Tensor, *,
                              copies: bool = True) -> torch.Tensor:
    """Plain version: gather the im2col rows by indexing (a zero slab
    without ``copies``), the f32 product, the max over the 40-column phase
    groups, ReLU, bf16. (B·1156, 12), (128, 160) bf16 -> (B·1024, 40) bf16."""
    frames = x.shape[0] // S2D_ROWS
    if copies:
        a = x[im2col_rows(frames, x.device)].reshape(frames * OUT_ROWS, PATCH).float()
        acc = a @ w[:PATCH].float()
    else:
        acc = torch.zeros((frames * OUT_ROWS, K), device=x.device) @ w.float()
    m = acc.view(-1, 4, PHASE_C).amax(dim=1)
    return torch.maximum(m, torch.zeros((), device=m.device)).to(torch.bfloat16)


def _check(x: torch.Tensor, w: torch.Tensor, frames_per_block: int) -> int:
    if x.dim() != 2 or x.shape[1] != S2D_C or x.shape[0] % S2D_ROWS:
        raise ValueError(f"front_end_probe: x must be (B*{S2D_ROWS}, {S2D_C}), "
                         f"got {tuple(x.shape)}")
    if tuple(w.shape) != (K, N):
        raise ValueError(f"front_end_probe: w must be ({K}, {N}), got {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"front_end_probe: want bfloat16, got {x.dtype}/{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"front_end_probe: inputs on {x.device} and {w.device}")
    frames = x.shape[0] // S2D_ROWS
    if frames_per_block < 2 or frames_per_block % 2:
        raise ValueError(f"front_end_probe: frames_per_block {frames_per_block} must be even "
                         "(wgmma's 64-row tile takes two frames)")
    if frames % frames_per_block:
        raise ValueError(f"front_end_probe: {frames} frames not a multiple of "
                         f"frames_per_block {frames_per_block}")
    return frames


def front_end_probe(x: torch.Tensor, w: torch.Tensor, *,
                    frames_per_block: int = DEFAULT_FRAMES_PER_BLOCK,
                    copies: bool = True) -> torch.Tensor:
    """(B·1024, 40) bf16 pooled phase max of the s2d im2col product.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    frames = _check(x, w, frames_per_block)
    if x.device.type == "cpu":
        return front_end_probe_reference(x, w, copies=copies)
    if x.device.type != "cuda":
        raise ValueError(f"front_end_probe: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("front_end_probe: inputs must be contiguous, x 16-byte aligned")
    out = torch.empty((frames * OUT_ROWS, PHASE_C), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        status = kb.library().cvt_front_end_probe(
            x.data_ptr(), w.data_ptr(), frames, frames_per_block, int(copies),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kb.check(status, "front_end_probe")
    kb.LAUNCHES["front_end_probe"] += 1
    return out


def probe_inputs(frames: int, device):
    """The TPU probe's random operands: x U[0, 1) and w N(0, 0.1), bf16."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((frames * S2D_ROWS, S2D_C))).bfloat16()
    w = torch.from_numpy(rng.normal(0, 0.1, (K, N))).bfloat16()
    return x.to(device), w.to(device)


def pack_frames(frames: torch.Tensor) -> torch.Tensor:
    """The probe's x for NCHW frames (B, 3, 64, 64): the space-to-depth of
    the frames padded by 2, as (B·1156, 12) bf16 rows."""
    xs = space_to_depth2(F.pad(frames.to(torch.bfloat16), (2, 2, 2, 2)))  # (B, 12, 34, 34)
    return xs.permute(0, 2, 3, 1).reshape(-1, S2D_C).contiguous()


def pack_weights(wm: torch.Tensor) -> torch.Tensor:
    """The probe's w for merged OIHW first-conv weights wm (40, 3, 5, 5): the
    s2d phase weights as (108, 160) rows (u, v, (p, q, c)) zero-padded to
    128, bf16."""
    w3 = s2d_pool_weights(wm)                         # (160, 12, 3, 3)
    w = F.pad(w3.permute(2, 3, 1, 0).reshape(PATCH, N), (0, 0, 0, K - PATCH))
    return w.to(torch.bfloat16).contiguous()


def pooled_phase_relu(frames: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """ReLU of the pool-phase max of ``s2d_conv_pool2_phases(frames, wm)``
    as the probe's (B·1024, 40) rows."""
    m = torch.relu(s2d_conv_pool2_phases(frames, wm).amax(dim=1))  # (B, 40, 32, 32)
    return m.permute(0, 2, 3, 1).reshape(-1, m.shape[1])


def library_front_end(frames: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """The fused path's function by library calls: cuDNN's 3×3 conv of the
    space-to-depth of the padded NCHW frames with the s2d phase weights w3
    (160, 12, 3, 3), the max over the four phases, ReLU -> (B, 40, 32, 32)."""
    y = F.conv2d(space_to_depth2(F.pad(frames, (2, 2, 2, 2))), w3)
    return torch.relu(y.view(y.shape[0], 4, PHASE_C, OUT_SIDE, OUT_SIDE).amax(dim=1))


def run(device: torch.device, frames: int = FRAMES,
        frames_per_block: int = DEFAULT_FRAMES_PER_BLOCK) -> dict:
    """Time both variants, the fused path and its library counterpart, and
    the cuDNN merged front end on the card (the plain versions, untimed, on
    the CPU); return the probe's record."""
    from critic_vae_tpu_torch.io.weights import synthetic_models
    from critic_vae_tpu_torch.ops.mask import merged_conv0_weight, merged_front_end

    x, w = probe_inputs(frames, device)
    res = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "frames": frames, "frames_per_block": frames_per_block,
           "copies_per_batch": frames}  # one bulk copy a frame
    if device.type != "cuda":
        for copies in (False, True):
            out = front_end_probe(x, w, frames_per_block=frames_per_block, copies=copies)
            res["copies_and_dot_shape" if copies else "dot_only_shape"] = list(out.shape)
        res["note"] = "plain PyTorch versions on the CPU; no time measured"
        return res

    def ms(fn):
        return cuda_ms(fn, iters=10, warmup=1, reps=5)

    for name, copies in (("dot_only", False), ("copies_and_dot", True)):
        res[f"{name}_ms"] = ms(
            lambda: front_end_probe(x, w, frames_per_block=frames_per_block, copies=copies))
    res["copy_floor_ms"] = res["copies_and_dot_ms"] - res["dot_only_ms"]
    res["ns_per_copy"] = 1e6 * res["copy_floor_ms"] / res["copies_per_batch"]
    critic, vae = synthetic_models(device)
    wm = merged_conv0_weight(vae, critic).to(torch.bfloat16)
    wk, w3 = pack_weights(wm), s2d_pool_weights(wm)
    g = torch.Generator(device=device).manual_seed(0)
    xf = torch.rand((frames, 3, 64, 64), generator=g, device=device).to(torch.bfloat16)
    with torch.inference_mode():
        # the same function from NCHW frames, s2d packing included in both
        res["fused_path_ms"] = ms(lambda: front_end_probe(
            pack_frames(xf), wk, frames_per_block=frames_per_block))
        res["library_path_ms"] = ms(lambda: library_front_end(xf, w3))
        res["cudnn_front_end_ms"] = ms(lambda: merged_front_end(vae, critic, xf, torch.bfloat16))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_json", nargs="?", help="also write the record here")
    ap.add_argument("--device", default="cuda", help="cuda (the kernel) or cpu (plain)")
    ap.add_argument("--frames", type=int, default=FRAMES)
    args = ap.parse_args(argv)
    frames_per_block = int(os.environ.get("PROBE_F", DEFAULT_FRAMES_PER_BLOCK))
    res = run(resolve_device(args.device), args.frames, frames_per_block)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
