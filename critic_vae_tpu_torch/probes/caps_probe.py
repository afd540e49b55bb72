"""Probe P1: can Hopper express the fused front-end kernel's building blocks?

Counterpart of examples/mosaic_caps_probe.py. The same three questions, at
the same shapes, as CUDA kernels (``csrc/caps_probe.cu``), each checked
against the same numpy expectation with the same tolerance as the TPU probe:

* Q1 ``q1_lane_offset_write``: nine 12-wide blocks ``x[:, t:t+12]`` written
  at column offsets 12t of a 128-wide shared-memory tile (the im2col
  build), then the tile stored;
* Q2 ``q2_phase_max_40``: the max over four 40-wide column groups of a
  (128, 160) tile (the pool-phase max);
* Q3 ``q3_fori_dyn_dot``: a loop over 4 frames with run-time row offsets 64f,
  each a (32, 128) @ (128, 160) bf16 tensor-core product with f32
  accumulation.

Each question has a plain PyTorch version here; the wrappers launch the
kernel for CUDA tensors and take the plain version for CPU tensors.

Run:  python -m critic_vae_tpu_torch.probes.caps_probe [OUT_JSON] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from critic_vae_tpu_torch.device import resolve_device
from critic_vae_tpu_torch.kernels import build as kb

TAPS, TAP_W = 9, 12
FRAMES, FRAME_STRIDE, FRAME_ROWS = 4, 64, 32

# how each question is answered on the card (csrc/caps_probe.cu)
INSTRUCTIONS = {
    "q1_lane_offset_write": (
        "st.shared.f32: one 4-byte store per element; the tile leaves with 16-byte "
        "st.global.v4.f32. The source slice x[:, t:t+12] starts at 4t bytes, and in the "
        "real bf16 front end a 12-channel block is 12 bf16 = 24 bytes, not a multiple of "
        "16, so neither 16-byte vector stores nor a TMA box (inner extent a multiple of "
        "16 bytes) can place it"),
    "q2_phase_max_40": (
        "16-byte ld.global.v4.f32 staging into shared memory, then four ld.shared.f32 at "
        "columns 40p + c and a NaN-propagating max in registers"),
    "q3_fori_dyn_dot": (
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 in a run-time loop over the "
        "4 frames; not wgmma, whose 64-row M tile is twice the 32 rows one frame gives"),
}


def _run(name: str, status: int) -> None:
    kb.check(status, name)
    kb.LAUNCHES["caps_probe"] += 1


def _require(t: torch.Tensor, name: str, shape, dtype) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def q1_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of Q1: (128, 20) f32 -> (128, 128) f32."""
    out = torch.zeros((x.shape[0], 128), dtype=x.dtype, device=x.device)
    for t in range(TAPS):
        out[:, TAP_W * t : TAP_W * (t + 1)] = x[:, t : t + TAP_W]
    return out


def q2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of Q2: (128, 160) f32 -> (128, 40) f32."""
    return x.view(x.shape[0], 4, 40).amax(dim=1)


def q3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of Q3: (256, 128), (128, 160) bf16 -> (128, 160) f32."""
    wf = w.float()
    return torch.cat([x[FRAME_STRIDE * f : FRAME_STRIDE * f + FRAME_ROWS].float() @ wf
                      for f in range(FRAMES)])


def q1_lane_offset_write(x: torch.Tensor) -> torch.Tensor:
    _require(x, "q1_lane_offset_write", (128, 20), torch.float32)
    if x.device.type == "cpu":
        return q1_reference(x)
    out = torch.empty((128, 128), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _run("caps_probe q1", kb.library().cvt_caps_q1(
            x.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream))
    return out


def q2_phase_max_40(x: torch.Tensor) -> torch.Tensor:
    _require(x, "q2_phase_max_40", (128, 160), torch.float32)
    if x.device.type == "cpu":
        return q2_reference(x)
    out = torch.empty((128, 40), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _run("caps_probe q2", kb.library().cvt_caps_q2(
            x.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream))
    return out


def q3_fori_dyn_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _require(x, "q3_fori_dyn_dot x", (256, 128), torch.bfloat16)
    _require(w, "q3_fori_dyn_dot w", (128, 160), torch.bfloat16)
    if x.device != w.device:
        raise ValueError(f"q3_fori_dyn_dot: inputs on {x.device} and {w.device}")
    if x.device.type == "cpu":
        return q3_reference(x, w)
    out = torch.empty((128, 160), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _run("caps_probe q3", kb.library().cvt_caps_q3(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream))
    return out


def probe_inputs(device: torch.device):
    """The TPU probe's inputs: (x1, x2, x3, w3) on ``device``."""
    x1 = torch.arange(128 * 20, dtype=torch.float32).reshape(128, 20)
    x2 = torch.from_numpy(np.random.default_rng(0).random((128, 160))).float()
    x3 = torch.from_numpy(np.random.default_rng(1).random((256, 128))).bfloat16()
    w3 = torch.from_numpy(np.random.default_rng(2).random((128, 160))).bfloat16()
    return tuple(t.to(device) for t in (x1, x2, x3, w3))


def expectations(x1, x2, x3, w3):
    """The TPU probe's numpy expectations for the three questions."""
    xn = x1.cpu().numpy()
    e1 = np.zeros((128, 128), np.float32)
    for t in range(TAPS):
        e1[:, TAP_W * t : TAP_W * (t + 1)] = xn[:, t : t + TAP_W]
    e2 = x2.cpu().numpy().reshape(128, 4, 40).max(axis=1)
    x3n, w3n = x3.float().cpu().numpy(), w3.float().cpu().numpy()
    e3 = np.concatenate([x3n[FRAME_STRIDE * f : FRAME_STRIDE * f + FRAME_ROWS] @ w3n
                         for f in range(FRAMES)])
    return e1, e2, e3


def answers(outs, exps) -> dict:
    """The three answers with the TPU probe's tolerances."""
    o1, o2, o3 = (o.cpu().numpy() for o in outs)
    e1, e2, e3 = exps
    return {
        "q1_lane_offset_write": bool(np.allclose(o1, e1)),
        "q2_phase_max_40": bool(np.allclose(o2, e2)),
        "q3_fori_dyn_dot": bool(np.allclose(o3, e3, atol=0.5, rtol=0.05)),
    }


def run(device: torch.device) -> dict:
    """Ask the three questions on ``device`` (the kernels on CUDA, the plain
    versions on the CPU) and return the probe's JSON record."""
    x1, x2, x3, w3 = probe_inputs(device)
    outs = (q1_lane_offset_write(x1), q2_phase_max_40(x2), q3_fori_dyn_dot(x3, w3))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    res = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        **answers(outs, expectations(x1, x2, x3, w3)),
    }
    res["instructions"] = (INSTRUCTIONS if device.type == "cuda"
                           else dict.fromkeys(INSTRUCTIONS, "plain PyTorch version"))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_json", nargs="?", help="also write the record here")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain)")
    args = ap.parse_args(argv)
    res = run(resolve_device(args.device))
    for key in ("q1_lane_offset_write", "q2_phase_max_40", "q3_fori_dyn_dot"):
        print(f"{key}: {res[key]} ({res['instructions'][key]})", flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(res, f, indent=2)
    print(json.dumps(res))
    return 0 if all(res[k] is True for k in INSTRUCTIONS) else 1


if __name__ == "__main__":
    raise SystemExit(main())
