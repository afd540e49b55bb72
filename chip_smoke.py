#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (critic_vae_tpu_torch) on one NVIDIA GPU.

Run from the repo root on a machine with a CUDA card:  python3 chip_smoke.py

Phases, each on its own lines, in order; any failure raises and the script
exits non-zero:

1. card identity (nvidia-smi name and power limit, torch's device name);
2. kernel build: nvcc compiles critic_vae_tpu_torch/csrc/*.cu for sm_90a;
3. kernel B1 (diff_mask) against its plain version at (512, 3, 64, 64),
   f32 and bf16 — bar: max abs error <= 1e-6 on grey maps and maxima;
4. kernel B2 (bilateral_build) against its plain version at C=4, N=4096
   (f32: <= 1e-5 relative on entries > 1e-3; bf16: within 1 bf16 ulp; the
   diagonal exactly 0), then timed at the main path's C=64 in bf16;
5. golden: the port in float32 with TF32 off on the 16-frame episode of
   tests/golden/torch_slice_golden.npz, which the JAX package computed on
   the CPU — preds <= 1e-4 abs, uint8 diff maps >= 99.9% within one level,
   threshold masks >= 99.8% identical, thr_iou equal, crf_iou within 0.001;
   and the bf16 CRF >= 99.9% in agreement with the float32 CRF;
6. main path: ``eval_episode`` as ``python -m critic_vae_tpu_torch video``
   runs it, on 2048 synthetic 64x64 frames at full width (critic
   saved-networks/critic-synthetic.npz, VAE numpy_vae_params(0)), bf16,
   chunks of 512, threshold 50, device CRF with B2 in bf16; both kernels'
   launch counts over that run must be > 0.

The second-to-last line is a JSON object with each kernel's launches on the
main path, error against its plain version and times; the last line is
{"ok": true, "device": {...}}. Without CUDA the script fails and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_FRAMES = 2048
MAIN_BATCH = 512
CRF_CHUNK = 64  # refine_masks_device's default frame_chunk


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_identity():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[1 card] nvidia-smi: {smi}")
    log(f"[1 card] torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"count {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    return smi


def phase_build():
    from critic_vae_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    lib = kb.library()
    log(f"[2 build] {kb.library_path().name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: {' '.join(kb.NVCC_FLAGS)}")
    return lib


def phase_b1(dev):
    import torch

    from critic_vae_tpu_torch.ops.diff_mask import diff_mask, diff_mask_reference

    g = torch.Generator(device=dev).manual_seed(1)
    shape = (MAIN_BATCH, 3, 64, 64)
    row = None
    for dt in (torch.float32, torch.bfloat16):
        a = (2.0 * torch.randn(shape, generator=g, device=dev)).to(dt)
        b = (2.0 * torch.randn(shape, generator=g, device=dev)).to(dt)
        grey_k, max_k = diff_mask(a, b)
        grey_r, max_r = diff_mask_reference(a, b)
        torch.cuda.synchronize()
        err = max((grey_k - grey_r).abs().max().item(), (max_k - max_r).abs().max().item())
        ms = cuda_ms(lambda: diff_mask(a, b), iters=50)
        plain_ms = cuda_ms(lambda: diff_mask_reference(a, b), iters=50)
        log(f"[3 B1 diff_mask] {tuple(shape)} {str(dt)[6:]}: max_abs_err {err:.3e} "
            f"(bar 1e-6); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(err <= 1e-6, f"B1 {dt}: max abs error {err} > 1e-6")
        if dt == torch.bfloat16:  # the main path's dtype
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return row


def _bf16_ulps(x, y) -> int:
    """Largest distance in bf16 ulps between two non-negative bf16 tensors."""
    import torch

    return (x.view(torch.int16).int() - y.view(torch.int16).int()).abs().max().item()


def phase_b2(dev):
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.fused_build import build_bilateral, build_bilateral_reference
    from critic_vae_tpu_torch.data.synthetic import generate_frames

    w1, alpha, beta = REFERENCE_CRF_PARAMS[:3]
    h = w = 64
    n = h * w

    def imgs(c, seed):
        frames, _ = generate_frames(c, seed=seed)
        return torch.from_numpy(frames.reshape(c, n, 3)).to(dev)

    small = imgs(4, 1)
    for out_dtype in ("float32", "bfloat16"):
        mk = build_bilateral(small, w1, alpha, beta, h=h, w=w, out_dtype=out_dtype)
        mr = build_bilateral_reference(small, w1, alpha, beta, h=h, w=w, out_dtype=out_dtype)
        torch.cuda.synchronize()
        diag = torch.diagonal(mk, dim1=1, dim2=2).abs().max().item()
        require(diag == 0.0, f"B2 {out_dtype}: diagonal not exactly 0 ({diag})")
        if out_dtype == "float32":
            sig = mr.abs() > 1e-3
            rel = ((mk - mr).abs()[sig] / mr.abs()[sig]).max().item()
            log(f"[4 B2 bilateral_build] C=4 N={n} float32: max_rel_err {rel:.3e} on "
                f"{int(sig.sum())} entries > 1e-3 (bar 1e-5); diagonal max {diag}")
            require(rel <= 1e-5, f"B2 float32: max relative error {rel} > 1e-5")
        else:
            ulps = _bf16_ulps(mk, mr)
            log(f"[4 B2 bilateral_build] C=4 N={n} bfloat16: max {ulps} bf16 ulp "
                f"(bar 1); diagonal max {diag}")
            require(ulps <= 1, f"B2 bfloat16: {ulps} ulps from the plain version")
        del mk, mr

    chunk = imgs(CRF_CHUNK, 2)
    mk = build_bilateral(chunk, w1, alpha, beta, h=h, w=w, out_dtype="bfloat16")
    mr = build_bilateral_reference(chunk, w1, alpha, beta, h=h, w=w, out_dtype="bfloat16")
    torch.cuda.synchronize()
    ulps = _bf16_ulps(mk, mr)
    err = (mk.float() - mr.float()).abs().max().item()
    require(ulps <= 1, f"B2 bfloat16 C={CRF_CHUNK}: {ulps} ulps from the plain version")
    del mk, mr
    ms = cuda_ms(lambda: build_bilateral(chunk, w1, alpha, beta, h=h, w=w), iters=10)
    plain_ms = cuda_ms(lambda: build_bilateral_reference(chunk, w1, alpha, beta, h=h, w=w),
                       iters=2, warmup=1)
    log(f"[4 B2 bilateral_build] C={CRF_CHUNK} N={n} bfloat16: max {ulps} ulp, "
        f"max_abs_err {err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _models(dev):
    from critic_vae_tpu_torch.io import weights

    critic = weights.critic_from_params(
        weights.load_critic_npz(str(ROOT / "saved-networks" / "critic-synthetic.npz")))
    vae = weights.vae_from_params(*weights.numpy_vae_params(0))
    return critic.to(dev), vae.to(dev)


def phase_golden(dev, critic, vae):
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.device import refine_masks_device
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.ops.iou import iou
    from critic_vae_tpu_torch.pipelines.video import eval_episode

    gold = np.load(ROOT / "tests" / "golden" / "torch_slice_golden.npz")
    frames, gt = generate_frames(int(gold["num_frames"]), seed=int(gold["seed"]))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    # float32 parity: no TF32 in convs or matmuls, no reduced bf16 reductions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        res = eval_episode(vae, critic, frames, gt, device=dev,
                           threshold=int(gold["threshold"]), run_crf=False,
                           compute_dtype="float32")
        thr_dev = torch.from_numpy(res.thr_masks).to(dev)
        crf32 = refine_masks_device(frames, thr_dev, REFERENCE_CRF_PARAMS,
                                    compute_dtype="float32", device=dev)
        crf16 = refine_masks_device(frames, thr_dev, REFERENCE_CRF_PARAMS,
                                    compute_dtype="bfloat16", device=dev)
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags
    thr_gold = np.unpackbits(gold["thr_bits"], axis=-1).astype(bool)
    crf_gold = np.unpackbits(gold["crf_bits"], axis=-1).astype(bool)
    pred_err = float(np.abs(res.preds - gold["preds"]).max())
    diff_ok = float(np.mean(np.abs(res.diff_u8.astype(int) - gold["diff_u8"].astype(int)) <= 1))
    thr_agree = float(np.mean(res.thr_masks == thr_gold))
    crf_agree = float(np.mean(crf32 == crf_gold))
    bf16_agree = float(np.mean(crf16 == crf32))
    crf_iou = iou(gt, crf32)
    log(f"[5 golden] {len(frames)} frames f32, TF32 off: preds max_abs_err {pred_err:.3e} "
        f"(bar 1e-4); diff_u8 within 1 level {diff_ok:.6f} (bar 0.999); thr masks "
        f"identical {thr_agree:.6f} (bar 0.998); crf masks identical {crf_agree:.6f} "
        f"(bar 0.999)")
    log(f"[5 golden] thr_iou {res.thr_iou} vs {float(gold['thr_iou'])}; crf_iou {crf_iou} "
        f"vs {float(gold['crf_iou'])} (bar 0.001); bf16 CRF vs f32 CRF agreement "
        f"{bf16_agree:.6f} (bar 0.999)")
    require(pred_err <= 1e-4, f"golden preds error {pred_err}")
    require(diff_ok >= 0.999, f"golden diff_u8 within-1 share {diff_ok}")
    require(thr_agree >= 0.998, f"golden thr mask agreement {thr_agree}")
    require(crf_agree >= 0.999, f"golden crf mask agreement {crf_agree}")
    require(res.thr_iou == float(gold["thr_iou"]), "golden thr_iou differs")
    require(abs(crf_iou - float(gold["crf_iou"])) <= 1e-3, "golden crf_iou differs")
    require(bf16_agree >= 0.999, f"bf16 CRF agreement with f32 {bf16_agree}")


def phase_main(dev, critic, vae):
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.kernels import build as kb
    from critic_vae_tpu_torch.pipelines.video import episode_device_stage, eval_episode

    frames, gt = generate_frames(MAIN_FRAMES, seed=0)
    kw = dict(device=dev, threshold=50, batch_size=MAIN_BATCH,
              compute_dtype="bfloat16", crf_backend="auto")
    eval_episode(vae, critic, frames[:MAIN_BATCH], gt[:MAIN_BATCH], **kw)  # warm-up
    frames_dev = torch.from_numpy(frames).to(dev)
    episode_device_stage(vae, critic, frames_dev, MAIN_BATCH, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds, _, _, _ = episode_device_stage(vae, critic, frames_dev, MAIN_BATCH,
                                          compute_dtype="bfloat16")
    torch.cuda.synchronize()
    stage_fps = MAIN_FRAMES / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats(dev)
    kb.reset_launches()
    t0 = time.perf_counter()
    res = eval_episode(vae, critic, frames, gt, **kw)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[6 main] {MAIN_FRAMES} frames bf16, chunk {MAIN_BATCH}, threshold 50, device CRF "
        f"(B2 bf16): thr_iou {res.thr_iou}, crf_iou {res.crf_iou}")
    log(f"[6 main] device stage {stage_fps:.1f} frames/s; eval_episode end to end "
        f"{MAIN_FRAMES / e2e_s:.1f} frames/s ({e2e_s:.3f} s); peak memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    require(res.preds.shape == (MAIN_FRAMES,) and np.isfinite(res.preds).all(), "bad preds")
    require(np.isfinite(preds.cpu().numpy()).all(), "non-finite device-stage preds")
    require(res.diff_u8.shape == (MAIN_FRAMES, 64, 64), "bad diff_u8 shape")
    require(res.thr_masks.shape == res.crf_masks.shape == (MAIN_FRAMES, 64, 64), "bad masks")
    require(0.0 <= res.thr_iou <= 1.0 and 0.0 <= res.crf_iou <= 1.0, "IoU out of range")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    if not (ROOT / "critic_vae_tpu_torch").is_dir():
        print(f"chip_smoke: no critic_vae_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_identity()
    phase_build()
    b1 = phase_b1(dev)
    b2 = phase_b2(dev)
    critic, vae = _models(dev)
    phase_golden(dev, critic, vae)
    launches = phase_main(dev, critic, vae)

    kernels = [
        {"name": "diff_mask", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/diff_mask.cu",
         "replaces": "critic_vae_tpu/ops/pallas_kernels.py:74",
         "launches": launches["diff_mask"], **b1},
        {"name": "bilateral_build", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/bilateral_build.cu",
         "replaces": "critic_vae_tpu/crf/fused_build.py:97",
         "launches": launches["bilateral_build"], **b2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
