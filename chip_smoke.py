#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (critic_vae_tpu_torch) on one NVIDIA GPU.

Run from the repo root on a machine with a CUDA card:  python3 chip_smoke.py

Phases, each on its own lines, in order; any failure raises and the script
exits non-zero:

1. card identity (nvidia-smi name and power limit, torch's device name);
2. kernel build: one nvcc per critic_vae_tpu_torch/csrc/*.cu for sm_90a,
   all started together, linked into one library;
3. kernel B1 (diff_mask) against its plain version on the main path's
   (2 x 512, 3, 64, 64) decode and on a ragged (8, 3, 25, 25) one (the
   scalar-load instantiation) in f32, in bf16 with f32_tanh (the Pallas
   kernel's widened tanh) and in bf16 by default (tanh rounded to bf16, the
   JAX default) — bar: max abs error <= 1e-6 on grey maps and maxima; then
   every one of the 65,536 bf16 bit patterns in channel 0 of the decode at
   the critic value (16 frames, all else 0, so grey is exactly 0.2989
   |bf16 tanh|): the kernel equal to the plain version on the card with NaN
   positions equal, at most 16 values differing and each by at most one
   bf16 ulp of tanh, and the same bar against a CPU torch.tanh table. Each
   mode's device time (torch.profiler's kernel time over 50 launches, the
   inputs in turn over 4 decodes so that they come from HBM, not the L2),
   call time (CUDA events over 50 calls of the Python wrapper) and plain time;
4. kernel B2 (bilateral_build) against its plain version at C=4, N=4096
   and at a ragged N=2500 (50x50) (f32: <= 1e-5 relative on entries >
   1e-3; bf16: within 1 bf16 ulp; the diagonal exactly 0; M bitwise
   symmetric), then at the main path's C=64 in bf16 (the same bars), two
   launches bitwise identical in bf16 and f32, and timed there;
5. kernel B3 (kernel_i8_build) against its plain version at C=4 with
   N=4096, N=1024 (32x32) and a ragged N=400 (20x20: divides by 16, not by
   the 64-pixel tile), and at the main path's C=64, N=4096: int8 identical
   on >= 99.99% of entries and never more than 1 level apart, row sums
   equal to the kernel's own int8 row sums, diagonal 0, K8 bitwise equal
   to its transpose; timed at C=64 (the timed runs' outputs are the ones
   checked), and two launches bitwise identical there (K8 and row sums);
6. kernel B4 (matvec_i8) against its plain version at C=4 and C=64, L=2,
   on B3's K — bar: relative error <= 1e-5 (f32 summation order); timed;
7. kernel B5 (mean_field_resident) against its plain version at N=1024
   (32x32) and N=400 (20x20) with C=4, at C=2 and at the main path's C=64,
   N=4096, each at T=1 and T=13 (the sweep), 10 iterations, on
   mask-derived probabilities — bars: marginals max abs error <= 1e-2,
   labels >= 99.99% identical; at C=64 timed (the timed runs' outputs are
   the ones checked), two launches bitwise identical, the build alone
   (iters=0) timed, the iteration's time taken as the difference over 10,
   and beside it torch.bmm of a (64, 4096, 4096) bf16 M by 2T bf16 lanes
   with f32 sums (library_ms: the product each iteration computes);
8. golden: the port in float32 with TF32 off on the 16-frame episode of
   tests/golden/torch_slice_golden.npz, which the JAX package computed on
   the CPU — preds <= 1e-4 abs, uint8 diff maps >= 99.9% within one level,
   threshold masks >= 99.8% identical, thr_iou equal, crf_iou within 0.001;
   the bf16 CRF >= 99.9% in agreement with the float32 CRF; the 13-threshold
   sweep against tests/golden/torch_sweep_golden.npz (thr_iou equal, crf_iou
   within 0.001); and the int8 and vmem builds' masks of its first 4 frames
   >= 99.9% identical to the JAX package's;
9. main paths at full width (critic saved-networks/critic-synthetic.npz,
   VAE numpy_vae_params(0), 64x64, bf16, chunks of 512), each with the
   launch counts set to 0 just before it and read just after, each of its
   kernels launched at least once, and its frames/s printed:
   a. ``eval_episode`` (as ``python -m critic_vae_tpu_torch video`` runs
      it) on 2048 frames, threshold 50, default build: B1, B2;
   b. ``threshold_sweep`` (``video --sweep``) on 2048 frames, 13
      thresholds, default build: B1, B2;
   c. ``eval_episode`` with build int8: B1, B3, B4; masks >= 99.9% as a;
   d. ``eval_episode`` with build vmem: B1, B5 at T=1; masks >= 99.9% as a;
   e. ``threshold_sweep`` with build vmem on the first 512 frames: B1, B5
      at T=13; its refined mask sets >= 99.9% as the default build's.
   The builds of c-e are selected as a user selects them, through
   CRITIC_VAE_TPU_CRF_BUILD. Paths a-e run the default (merged) front end.
   After each timed run, one more run under torch.profiler prints the
   path's largest kernels by device time;
10. front end: at full width, 512 frames, ``episode_forward`` with each
   formulation (merged; fused_pool=True, i.e. critic "s2d" and encoder
   FUSED_POOL_SERVING; fused_pool=(True,)*4; fold_bn; pool_impl="strided";
   block0_f32) against the split front end, in float32 with TF32 off
   (preds <= 1e-4, uint8 diff maps >= 99.9% within one level, threshold-50
   masks >= 99.8% identical) and in bfloat16 (preds <= 2^-6, four bf16
   ulps below 1; diff maps within one level and masks identical to split's
   at least as often as split bf16's are to split float32's, bf16's own
   noise floor). Then each formulation's bf16 device-stage frames/s at
   chunk 512 and a torch.profiler breakdown of the default stage's kernels;
11. probe P1 (caps_probe): its entry path on the card with the launch count
   set to 0 just before and read just after; its three answers must be
   true (Q3 on wgmma, a frame pair's rows a 64-row tile), and each
   question's kernel is held against its plain version (Q1, Q2 exact; Q3
   <= 1e-5 relative) and timed on the device beside a kernel that does
   nothing (they are launch-bound), and by call;
12. probe P2 (copy_floor_probe): its entry path (both variants timed at
   B=1024, F=4; from NCHW frames the fused path, s2d packing plus kernel,
   beside the same function by library calls; and the cuDNN merged front
   end) with the launch count read as in 11; then both variants at B=1024
   and F = 2, 4 and 8 against the plain version (within one bf16 ulp, or
   1e-5 where f32 order moves a sum across 0 under the ReLU); a run whose x
   holds +Inf in the first s2d scanline of every odd frame, right after the
   even frame's last window (an unmasked K pad would read it), against the
   plain version with NaN positions compared as equal and every output row
   that the plain version leaves finite finite; and on 8 real frames with
   the merged 3->40 weights against ReLU of the phase max of
   s2d_conv_pool2_phases in f32 (within 2^-8 relative + 1e-5: one bf16
   rounding).

The second-to-last line is a JSON object with, for each of the seven kernels
(B1-B5, P1, P2), its launches on the path that runs it, its error against
its plain version, its times, its bound (the larger of its bytes over the
HBM rate and its operations over the peak rate of their type, from this
run's shapes) and the time of one PyTorch call computing the same function
where there is one (for B5, of its iteration's product; its row also has
build_ms and iter_ms, and each time again at T=13 as *_t13). B1's and P1's
``ms`` is device time and their ``call_ms`` the time of a call through the
Python wrapper (P1's rows sum the three questions, with ``empty_ms`` the
empty kernel's device time); the other kernels' ``ms`` are CUDA-event times
of calls, which their device time dominates. The last line is {"ok": true,
"device": {...}}. Without CUDA the script fails and prints no result. About
a minute on an H100, the build (~10 s) included.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_FRAMES = 2048
MAIN_BATCH = 512
CRF_CHUNK = 64  # refine_masks_device's default frame_chunk
H = W = 64
NPIX = H * W
SWEEP_T = 13               # the reference's -thresh sweep, 0..120 step 10
SWEEP_VMEM_FRAMES = 512    # frames of the vmem sweep path (9e)
RAGGED_SIDE = 50           # B2's ragged frames: N = 2500
FRONT_FRAMES = 512         # frames of the front-end phase (10)
BF16_PRED_BAR = 2.0 ** -6  # bf16 preds across front ends: 4 bf16 ulps below 1
# the card's published peaks (H100 SXM, dense): the bounds of the kernels line
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12        # tensor cores
F32_FLOPS = 67e12          # float32 outside the tensor cores
B1_BUFFERS = 4             # B1's timed decodes: 4 x 25.2 MB in turn exceed the 50 MB L2
B1_RAGGED_SIDE = 25        # B1's ragged frames: H*W = 625, no multiple of a 16-byte vector
# float32 operations of one bilateral kernel entry (5 feature differences, 5
# squares, 4 sums, 1 scale, 1 exp): a lower count, as a bound wants
ENTRY_OPS = 16
FRONT_ENDS = {
    "merged": dict(front_end="merged"),
    "fused_pool": dict(fused_pool=True),
    "fused_pool_all": dict(fused_pool=(True, True, True, True)),
    "fold_bn": dict(fold_bn=True),
    "strided": dict(pool_impl="strided"),
    "block0_f32": dict(block0_f32=True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(nbytes: float, ops) -> dict:
    """``bound_ms``: the larger of ``nbytes`` over the HBM rate and the
    operations ``ops`` ((count, peak per second) pairs) over their peaks."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * sum(count / peak for count, peak in ops)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@contextlib.contextmanager
def no_tf32():
    """float32 parity: no TF32 in convs or matmuls, no reduced bf16 reductions."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags


def timed(fn, iters: int, warmup: int = 2):
    """(ms per call, the last call's result), so a timed run is also checked."""
    from critic_vae_tpu_torch.device import cuda_ms

    last = [None]

    def run():
        last[0] = fn()

    return cuda_ms(run, iters, warmup), last[0]


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


def _b1_tanh_ulps(x, y):
    """B1's grey maps x and y of the exhaustive check: (whether their NaN
    positions are equal, how many non-NaN values differ, the largest gap in
    bf16 ulps of the tanh each implies, grey / 0.2989 rounded to bf16)."""
    import torch

    from critic_vae_tpu_torch.ops.diff_mask import REC601

    same_nan = torch.equal(torch.isnan(x), torch.isnan(y))
    differ = (x != y) & ~torch.isnan(x) & ~torch.isnan(y)
    count = int(differ.sum())
    if not count:
        return same_nan, 0, 0
    tx, ty = ((v[differ].float() / REC601[0]).bfloat16().view(torch.int16).int() for v in (x, y))
    return same_nan, count, int((tx - ty).abs().max())


def phase_b1(dev):
    """B1 against its plain version in its three modes at the main path's
    shape, on every bf16 value, and its device, call and plain times."""
    import itertools

    import torch

    from critic_vae_tpu_torch.device import cuda_ms, device_ms
    from critic_vae_tpu_torch.ops.diff_mask import diff_mask, diff_mask_reference

    g = torch.Generator(device=dev).manual_seed(1)
    shape = (2 * MAIN_BATCH, 3, H, W)  # the (2B, 3, H, W) decode
    err, row = 0.0, None
    for dt, f32_tanh in ((torch.float32, False), (torch.bfloat16, True), (torch.bfloat16, False)):
        # B1_BUFFERS decodes in turn, so a timed launch finds its input out of the L2
        pres = [(2.0 * torch.randn(shape, generator=g, device=dev)).to(dt)
                for _ in range(B1_BUFFERS)]
        # and a ragged 25x25 decode: H*W = 625 is odd, so the planes are not
        # 16-byte aligned and the scalar-load instantiation runs
        ragged = (2.0 * torch.randn((8, 3, B1_RAGGED_SIDE, B1_RAGGED_SIDE), generator=g,
                                    device=dev)).to(dt)
        e = 0.0
        for pre in (pres[0], ragged):
            grey_k, max_k = diff_mask(pre, f32_tanh=f32_tanh)
            grey_r, max_r = diff_mask_reference(pre, f32_tanh=f32_tanh)
            torch.cuda.synchronize()
            e = max(e, (grey_k - grey_r).abs().max().item(), (max_k - max_r).abs().max().item())
        err = max(err, e)
        turn = itertools.cycle(pres)
        ms = device_ms(lambda: diff_mask(next(turn), f32_tanh=f32_tanh), "diff_mask_kernel")
        call_ms = cuda_ms(lambda: diff_mask(next(turn), f32_tanh=f32_tanh), iters=50)
        plain_ms = cuda_ms(lambda: diff_mask_reference(next(turn), f32_tanh=f32_tanh), iters=20)
        label = f"{str(dt)[6:]}{' f32_tanh' if f32_tanh else ''}"
        b1 = b1_bound(pres[0].element_size())["bound_ms"]
        log(f"[3 B1 diff_mask] {shape} and {tuple(ragged.shape)} {label}: max_abs_err {e:.3e} "
            f"(bar 1e-6); {shape}: device "
            f"{ms:.4f} ms ({b1 / ms:.1%} of its {b1:.4f} ms byte bound), "
            f"call {call_ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(e <= 1e-6, f"B1 {label}: max abs error {e} > 1e-6")
        row = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms}  # bf16 default, the last
        del pres, grey_k, grey_r
    # every bf16 bit pattern in channel 0 of the decode at the critic value,
    # all else 0: grey is exactly 0.2989 |bf16 tanh|, with no FMA-order noise
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    frames = bits.numel() // NPIX
    one = torch.zeros((frames, 3, H, W), dtype=torch.bfloat16)
    one[:, 0] = bits.view(frames, H, W)
    pre_cpu = torch.cat([one, torch.zeros_like(one)])
    pre = pre_cpu.to(dev)
    grey_k, max_k = diff_mask(pre)
    grey_r, max_r = diff_mask_reference(pre)
    grey_c, _ = diff_mask_reference(pre_cpu)  # the CPU's torch.tanh, rounded to bf16
    torch.cuda.synchronize()
    same_nan, count, ulps = _b1_tanh_ulps(grey_k, grey_r)
    max_nan, max_count, _ = _b1_tanh_ulps(max_k, max_r)
    if count:
        at = torch.nonzero((grey_k != grey_r) & ~torch.isnan(grey_k) & ~torch.isnan(grey_r))
        for f, y, x in at[:16].tolist():
            log(f"[3 B1 diff_mask]   differs at bf16 input {bits.view(frames, H, W)[f, y, x]}: "
                f"kernel {grey_k[f, y, x].item()!r}, plain {grey_r[f, y, x].item()!r}")
    log(f"[3 B1 diff_mask] every bf16 ({bits.numel()} bit patterns, {frames} frames): kernel vs "
        f"plain on the card: NaN positions equal {same_nan and max_nan}, {count + max_count} "
        f"values differ (bar 16), max {ulps} bf16 ulp (bar 1)")
    require(same_nan and max_nan and count + max_count <= 16 and ulps <= 1,
            "B1: the kernel's bf16 tanh differs from its plain version's")
    cpu_nan, cpu_count, cpu_ulps = _b1_tanh_ulps(grey_k.cpu(), grey_c)
    log(f"[3 B1 diff_mask] every bf16: the card's rounding vs a CPU torch.tanh table: NaN "
        f"positions equal {cpu_nan}, {cpu_count} finite values differ (bar 16), max "
        f"{cpu_ulps} bf16 ulp (bar 1)")
    require(cpu_nan and cpu_count <= 16 and cpu_ulps <= 1,
            "B1: the card's bf16 tanh differs from the CPU's")
    return {"max_abs_err": err, **row}


def _bf16_ulps(x, y) -> int:
    """Largest distance in bf16 ulps between two non-negative bf16 tensors."""
    import torch

    return (x.view(torch.int16).int() - y.view(torch.int16).int()).abs().max().item()


def _check_b2(mk, mr, out_dtype, label):
    """B2's M against its plain version's: the diagonal exactly 0, M bitwise
    symmetric, f32 within 1e-5 relative on entries > 1e-3, bf16 within 1
    ulp. Returns the max abs error."""
    import torch

    diag = torch.diagonal(mk, dim1=1, dim2=2).abs().max().item()
    sym = torch.equal(mk, mk.transpose(1, 2))
    err = (mk.float() - mr.float()).abs().max().item()
    if out_dtype == "float32":
        sig = mr.abs() > 1e-3
        rel = ((mk - mr).abs()[sig] / mr.abs()[sig]).max().item()
        log(f"[4 B2 bilateral_build] {label} float32: max_rel_err {rel:.3e} on "
            f"{int(sig.sum())} entries > 1e-3 (bar 1e-5); diagonal max {diag}; bitwise "
            f"symmetric {sym}")
        require(rel <= 1e-5, f"B2 {label} float32: max relative error {rel} > 1e-5")
    else:
        ulps = _bf16_ulps(mk, mr)
        log(f"[4 B2 bilateral_build] {label} bfloat16: max {ulps} bf16 ulp (bar 1), "
            f"max_abs_err {err:.3e}; diagonal max {diag}; bitwise symmetric {sym}")
        require(ulps <= 1, f"B2 {label} bfloat16: {ulps} ulps from the plain version")
    require(diag == 0.0, f"B2 {label} {out_dtype}: diagonal not exactly 0 ({diag})")
    require(sym, f"B2 {label} {out_dtype}: M is not bitwise symmetric")
    return err


def phase_b2(dev):
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.fused_build import build_bilateral, build_bilateral_reference
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.device import cuda_ms

    w1, alpha, beta = REFERENCE_CRF_PARAMS[:3]

    def imgs(c, seed, side=H):
        frames, _ = generate_frames(c, size=side, seed=seed)
        return torch.from_numpy(frames.reshape(c, side * side, 3)).to(dev)

    # C=4 at N=4096, and a ragged N=2500 (50x50: not a multiple of the
    # 64-pixel tile, nor of the 8 bf16 of a 16-byte store)
    for c, side in ((4, H), (4, RAGGED_SIDE)):
        small = imgs(c, 1, side)
        for out_dtype in ("float32", "bfloat16"):
            kw = dict(h=side, w=side, out_dtype=out_dtype)
            mk = build_bilateral(small, w1, alpha, beta, **kw)
            mr = build_bilateral_reference(small, w1, alpha, beta, **kw)
            torch.cuda.synchronize()
            _check_b2(mk, mr, out_dtype, f"C={c} N={side * side}")
            del mk, mr

    chunk = imgs(CRF_CHUNK, 2)
    mk = build_bilateral(chunk, w1, alpha, beta, h=H, w=W, out_dtype="bfloat16")
    mr = build_bilateral_reference(chunk, w1, alpha, beta, h=H, w=W, out_dtype="bfloat16")
    torch.cuda.synchronize()
    err = _check_b2(mk, mr, "bfloat16", f"C={CRF_CHUNK} N={NPIX}")
    del mr
    for out_dtype in ("bfloat16", "float32"):  # two launches, bitwise the same
        a = build_bilateral(chunk, w1, alpha, beta, h=H, w=W, out_dtype=out_dtype)
        same = torch.equal(a, build_bilateral(chunk, w1, alpha, beta, h=H, w=W,
                                              out_dtype=out_dtype))
        log(f"[4 B2 bilateral_build] C={CRF_CHUNK} {out_dtype}: two launches bitwise "
            f"identical {same}")
        require(same, f"B2 {out_dtype}: two launches differ")
        del a
    del mk
    ms = cuda_ms(lambda: build_bilateral(chunk, w1, alpha, beta, h=H, w=W), iters=10)
    plain_ms = cuda_ms(lambda: build_bilateral_reference(chunk, w1, alpha, beta, h=H, w=W),
                       iters=2, warmup=1)
    b2_bound = crf_bounds()[1]["bound_ms"]
    log(f"[4 B2 bilateral_build] C={CRF_CHUNK} N={NPIX} bfloat16: kernel {ms:.3f} ms "
        f"({b2_bound / ms:.1%} of its {b2_bound:.3f} ms byte bound), plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _crf_imgs(c, seed, dev, side=H):
    """(c, N, 3) uint8 synthetic side x side frames on the card."""
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames

    frames, _ = generate_frames(c, size=side, seed=seed)
    return torch.from_numpy(frames.reshape(c, side * side, 3)).to(dev)


def _check_b3(k8, rowsum, k8r, c, n=NPIX):
    """B3 against its plain version's int8 on C=c frames of n pixels;
    returns the max level gap."""
    import torch

    lvl = (k8.int() - k8r.int()).abs()
    err = lvl.max().item()
    same = (lvl == 0).double().mean().item()
    own = k8.sum(dim=1, keepdim=True, dtype=torch.int32).float()
    rows_ok = torch.equal(rowsum, own)
    kv = k8.view(c, n, n)
    diag = torch.diagonal(kv, dim1=1, dim2=2).abs().max().item()
    sym = torch.equal(kv, kv.transpose(1, 2))
    log(f"[5 B3 kernel_i8_build] C={c} N={n}: int8 identical {same:.8f} (bar 0.9999), "
        f"max {err} level (bar 1); row sums equal to its own int8 row sums: {rows_ok}; "
        f"diagonal max {diag}; bitwise symmetric {sym}")
    require(same >= 0.9999 and err <= 1, f"B3 C={c} N={n}: identical {same}, max {err} levels")
    require(rows_ok, f"B3 C={c} N={n}: row sums differ from the sums of the stored int8 rows")
    require(diag == 0, f"B3 C={c} N={n}: diagonal not 0 ({diag})")
    require(sym, f"B3 C={c} N={n}: K8 is not bitwise symmetric")
    return err


def phase_b3(dev):
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.fused_build import build_kernel_i8, build_kernel_i8_reference

    alpha, beta = REFERENCE_CRF_PARAMS[1:3]
    err = 0
    # N=4096, N=1024 and a ragged N=400 (20x20: divides by 16 for the int8
    # 16-byte stores, but not by the 64-pixel tile)
    for side in (H, 32, 20):
        small = _crf_imgs(4, 1, dev, side)
        k8, rowsum = build_kernel_i8(small, alpha, beta, h=side, w=side)
        k8r, _ = build_kernel_i8_reference(small, alpha, beta, h=side, w=side)
        torch.cuda.synchronize()
        err = max(err, _check_b3(k8, rowsum, k8r, 4, side * side))
        del k8, k8r
    chunk = _crf_imgs(CRF_CHUNK, 2, dev)
    ms, (k8, rowsum) = timed(lambda: build_kernel_i8(chunk, alpha, beta, h=H, w=W), iters=10)
    plain_ms, (k8r, _) = timed(lambda: build_kernel_i8_reference(chunk, alpha, beta, h=H, w=W),
                               iters=2, warmup=1)
    b3_bound = crf_bounds()[2]["bound_ms"]
    log(f"[5 B3 kernel_i8_build] C={CRF_CHUNK} N={NPIX}: kernel {ms:.3f} ms ({b3_bound / ms:.1%} "
        f"of its {b3_bound:.3f} ms byte bound), plain {plain_ms:.3f} ms")
    err = max(err, _check_b3(k8, rowsum, k8r, CRF_CHUNK))
    del k8r
    k8b, rowsum_b = build_kernel_i8(chunk, alpha, beta, h=H, w=W)
    same = torch.equal(k8, k8b) and torch.equal(rowsum, rowsum_b)
    log(f"[5 B3 kernel_i8_build] C={CRF_CHUNK}: two launches bitwise identical (K8 and row "
        f"sums) {same}")
    require(same, "B3: two launches differ")
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}


def phase_b4(dev):
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.fused_build import (
        build_kernel_i8,
        matvec_i8,
        matvec_i8_reference,
    )
    from critic_vae_tpu_torch.device import cuda_ms

    alpha, beta = REFERENCE_CRF_PARAMS[1:3]
    g = torch.Generator(device=dev).manual_seed(4)
    row = None
    for c in (4, CRF_CHUNK):
        k8, _ = build_kernel_i8(_crf_imgs(c, 3, dev), alpha, beta, h=H, w=W)
        y = torch.rand((c * NPIX, 2), generator=g, device=dev)
        out = matvec_i8(k8, y, n=NPIX)
        ref = matvec_i8_reference(k8, y.to(torch.bfloat16), n=NPIX)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = cuda_ms(lambda: matvec_i8(k8, y, n=NPIX), iters=20)
        plain_ms = cuda_ms(lambda: matvec_i8_reference(k8, y.to(torch.bfloat16), n=NPIX),
                           iters=5)
        log(f"[6 B4 matvec_i8] C={c} N={NPIX} L=2: relative error {rel:.3e} (bar 1e-5), "
            f"max_abs_err {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(rel <= 1e-5, f"B4 C={c}: relative error {rel} > 1e-5")
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del k8, y, out, ref
    return row


def _sweep_probs(c, t, seed, dev, side=H):
    """(c, N, 2t) (neg, pos) probabilities of t noisy 0/1 masks per frame,
    as the main path builds them from threshold masks."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames

    _, gt = generate_frames(c, size=side, seed=seed)
    rng = np.random.default_rng(seed)
    rates = np.linspace(0.02, 0.3, t)
    m = np.stack([gt ^ (rng.random(gt.shape) < r) for r in rates], axis=-1)
    m = torch.from_numpy(m.reshape(c, side * side, t).astype(np.float32)).to(dev)
    return torch.stack([1.0 - m, m], dim=-1).reshape(c, side * side, 2 * t)


def _check_b5(q, qr, c, t, iters, n=NPIX):
    """B5's marginals against its plain version's; returns the max abs error."""
    err = (q - qr).abs().max().item()
    labels = ((q[..., 1::2] > q[..., 0::2]) == (qr[..., 1::2] > qr[..., 0::2]))
    agree = labels.double().mean().item()
    log(f"[7 B5 mean_field_resident] C={c} N={n} T={t} iters={iters}: marginals "
        f"max_abs_err {err:.3e} (bar 1e-2); labels identical {agree:.6f} (bar 0.9999)")
    require(err <= 1e-2, f"B5 C={c} N={n} T={t}: marginals max abs error {err}")
    require(agree >= 0.9999, f"B5 C={c} N={n} T={t}: label agreement {agree}")
    return err


def phase_b5(dev):
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.device import _spatial_taps
    from critic_vae_tpu_torch.crf.fused_build import build_bilateral
    from critic_vae_tpu_torch.crf.fused_resident import (
        mean_field_resident,
        mean_field_resident_reference,
    )
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.device import cuda_ms

    w1, alpha, beta, w2, gamma, iters = REFERENCE_CRF_PARAMS
    args = (w1, w2, alpha, beta, gamma)

    def both(imgs, probs, side, n_iter=iters):
        taps = torch.from_numpy(_spatial_taps(gamma, side, side)).to(dev)
        kw = dict(h=side, w=side, iters=n_iter)
        return (lambda: mean_field_resident(imgs, probs, taps, *args, **kw),
                lambda: mean_field_resident_reference(imgs, probs, taps, *args, **kw))

    # the smallest N the vmem build admits below 4096 (32x32), and N=400
    # (20x20: no multiple of the 64-pixel tile or the 128-row block)
    small_err = 0.0
    for side in (32, 20):
        for t in (1, SWEEP_T):
            frames, _ = generate_frames(4, size=side, seed=8)
            imgs = torch.from_numpy(frames.reshape(4, side * side, 3)).to(dev)
            probs = _sweep_probs(4, t, 8, dev, side)
            kern, plain = both(imgs, probs, side)
            small_err = max(small_err, _check_b5(kern(), plain(), 4, t, iters, side * side))
    rows = {}
    for t in (1, SWEEP_T):
        imgs, probs = _crf_imgs(2, 5, dev), _sweep_probs(2, t, 5, dev)
        kern, plain = both(imgs, probs, H)
        q, qr = kern(), plain()
        torch.cuda.synchronize()
        err = max(small_err, _check_b5(q, qr, 2, t, iters))
        imgs, probs = _crf_imgs(CRF_CHUNK, 6, dev), _sweep_probs(CRF_CHUNK, t, 6, dev)
        kern, plain = both(imgs, probs, H)
        build_only, _ = both(imgs, probs, H, n_iter=0)
        ms, q = timed(kern, iters=5, warmup=1)
        build_ms = cuda_ms(build_only, iters=5, warmup=1)
        plain_ms, qr = timed(plain, iters=1, warmup=1)
        same = torch.equal(q, kern())
        log(f"[7 B5 mean_field_resident] C={CRF_CHUNK} N={NPIX} T={t} iters={iters}: kernel "
            f"{ms:.3f} ms, build (iters=0) {build_ms:.3f} ms, iteration "
            f"{(ms - build_ms) / iters:.4f} ms; plain {plain_ms:.3f} ms; two launches bitwise "
            f"identical {same}")
        require(same, f"B5 T={t}: two launches differ")
        err = max(err, _check_b5(q, qr, CRF_CHUNK, t, iters))
        del q, qr, probs
        # the iteration's yardstick: one bmm of a bf16 M of the chunk's shape
        # by 2T bf16 lanes, f32 sums, as the default build's mean field runs it
        m = build_bilateral(imgs, w1, alpha, beta, h=H, w=W)
        y = torch.rand((CRF_CHUNK, NPIX, 2 * t), device=dev).to(torch.bfloat16)
        library_ms = cuda_ms(lambda: torch.bmm(m, y, torch.float32), iters=20)
        log(f"[7 B5 mean_field_resident] T={t}: library (torch.bmm of the ({CRF_CHUNK}, {NPIX}, "
            f"{NPIX}) bf16 M by {2 * t} bf16 lanes, f32 out) {library_ms:.4f} ms against the "
            f"iteration's {(ms - build_ms) / iters:.4f} ms")
        rows[t] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "build_ms": build_ms,
                   "iter_ms": (ms - build_ms) / iters, "library_ms": library_ms}
        del imgs, m, y
    # T=1 (one mask) as the row's times, the sweep's T=13 beside them; the
    # error is the larger of the two
    return {**rows[1], "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            **{f"{k}_t13": rows[SWEEP_T][k] for k in ("ms", "plain_ms", "build_ms", "iter_ms",
                                                      "library_ms")}}


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
    with no_tf32():
        res = eval_episode(vae, critic, frames, gt, device=dev,
                           threshold=int(gold["threshold"]), run_crf=False,
                           compute_dtype="float32")
        thr_dev = torch.from_numpy(res.thr_masks).to(dev)
        crf32 = refine_masks_device(frames, thr_dev, REFERENCE_CRF_PARAMS,
                                    compute_dtype="float32", device=dev)
        crf16 = refine_masks_device(frames, thr_dev, REFERENCE_CRF_PARAMS,
                                    compute_dtype="bfloat16", device=dev)
    thr_gold = np.unpackbits(gold["thr_bits"], axis=-1).astype(bool)
    crf_gold = np.unpackbits(gold["crf_bits"], axis=-1).astype(bool)
    pred_err = float(np.abs(res.preds - gold["preds"]).max())
    diff_ok = float(np.mean(np.abs(res.diff_u8.astype(int) - gold["diff_u8"].astype(int)) <= 1))
    thr_agree = float(np.mean(res.thr_masks == thr_gold))
    crf_agree = float(np.mean(crf32 == crf_gold))
    bf16_agree = float(np.mean(crf16 == crf32))
    crf_iou = iou(gt, crf32)
    log(f"[8 golden] {len(frames)} frames f32, TF32 off: preds max_abs_err {pred_err:.3e} "
        f"(bar 1e-4); diff_u8 within 1 level {diff_ok:.6f} (bar 0.999); thr masks "
        f"identical {thr_agree:.6f} (bar 0.998); crf masks identical {crf_agree:.6f} "
        f"(bar 0.999)")
    log(f"[8 golden] thr_iou {res.thr_iou} vs {float(gold['thr_iou'])}; crf_iou {crf_iou} "
        f"vs {float(gold['crf_iou'])} (bar 0.001); bf16 CRF vs f32 CRF agreement "
        f"{bf16_agree:.6f} (bar 0.999)")
    require(pred_err <= 1e-4, f"golden preds error {pred_err}")
    require(diff_ok >= 0.999, f"golden diff_u8 within-1 share {diff_ok}")
    require(thr_agree >= 0.998, f"golden thr mask agreement {thr_agree}")
    require(crf_agree >= 0.999, f"golden crf mask agreement {crf_agree}")
    require(res.thr_iou == float(gold["thr_iou"]), "golden thr_iou differs")
    require(abs(crf_iou - float(gold["crf_iou"])) <= 1e-3, "golden crf_iou differs")
    require(bf16_agree >= 0.999, f"bf16 CRF agreement with f32 {bf16_agree}")
    phase_golden_sweep(dev, critic, vae, frames, gt, thr_gold)


def phase_golden_sweep(dev, critic, vae, frames, gt, thr_gold):
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.device import refine_masks_device
    from critic_vae_tpu_torch.pipelines.video import threshold_sweep

    gold = np.load(ROOT / "tests" / "golden" / "torch_sweep_golden.npz")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = threshold_sweep(vae, critic, frames, gt, tuple(gold["thresholds"].tolist()),
                              device=dev, compute_dtype="float32", crf_backend="device")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    thr_iou = [r["thr_iou"] for r in res]
    crf_iou = [r["crf_iou"] for r in res]
    crf_gap = float(np.abs(np.asarray(crf_iou) - gold["crf_iou"]).max())
    log(f"[8 golden] sweep of {len(res)} thresholds (nets f32, CRF M bf16): thr_iou "
        f"{thr_iou} equal to the JAX f32 sweep's: {thr_iou == gold['thr_iou'].tolist()}; "
        f"crf_iou {crf_iou}, max gap {crf_gap:.4f} (bar 0.001)")
    require(thr_iou == gold["thr_iou"].tolist(), "golden sweep thr_iou differs")
    require(crf_gap <= 1e-3, f"golden sweep crf_iou gap {crf_gap}")
    nb = int(gold["build_frames"])
    for build in ("int8", "vmem"):
        got = refine_masks_device(frames[:nb], thr_gold[:nb], REFERENCE_CRF_PARAMS,
                                  build=build, device=dev)
        want = np.unpackbits(gold[f"{build}_bits"], axis=-1).astype(bool)
        agree = float(np.mean(got == want))
        log(f"[8 golden] build {build}, first {nb} frames: masks identical to the JAX "
            f"package's {agree:.6f} (bar 0.999)")
        require(agree >= 0.999, f"golden {build} mask agreement {agree}")


@contextlib.contextmanager
def crf_build(build):
    """Select the device CRF's build as a user does, through
    CRITIC_VAE_TPU_CRF_BUILD (crf/device.py::_resolve_build)."""
    from critic_vae_tpu_torch.crf.device import BUILD_ENV

    old = os.environ.get(BUILD_ENV)
    os.environ[BUILD_ENV] = build
    try:
        yield
    finally:
        if old is None:
            del os.environ[BUILD_ENV]
        else:
            os.environ[BUILD_ENV] = old


def _drive(name, fn, kernels, frames):
    """Run one main path with the launch counts set to 0 just before it and
    read just after; each of ``kernels`` must have launched."""
    import torch

    from critic_vae_tpu_torch.kernels import build as kb

    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    log(f"[9 main {name}] {frames} frames: {frames / secs:.1f} frames/s ({secs:.3f} s); "
        f"launches {launches}")
    require(all(launches[k] > 0 for k in kernels),
            f"{name}: a kernel of the path was not launched: {launches}")
    return out, launches


def _profile(key, fn, top=6):
    """One more run of a path under torch.profiler: its largest kernels by
    device time."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events)
    log(f"[9 main {key}] profile of one more run: {total / 1e3:.3f} ms of kernels")
    for e in events[:top]:
        log(f"[9 main {key}]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} "
            f"{e.key[:100]}")


def phase_main(dev, critic, vae):
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf.device import refine_masks_multi_device
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.ops.mask import threshold_masks
    from critic_vae_tpu_torch.pipelines.video import (
        DEFAULT_SWEEP,
        episode_device_stage,
        eval_episode,
        threshold_sweep,
    )

    frames, gt = generate_frames(MAIN_FRAMES, seed=0)
    kw = dict(device=dev, batch_size=MAIN_BATCH, compute_dtype="bfloat16", crf_backend="auto")
    warm = (frames[:MAIN_BATCH], gt[:MAIN_BATCH])
    eval_episode(vae, critic, *warm, threshold=50, **kw)  # warm-up
    frames_dev = torch.from_numpy(frames).to(dev)
    episode_device_stage(vae, critic, frames_dev, MAIN_BATCH, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds, _, _, _ = episode_device_stage(vae, critic, frames_dev, MAIN_BATCH,
                                          compute_dtype="bfloat16")
    torch.cuda.synchronize()
    stage_fps = MAIN_FRAMES / (time.perf_counter() - t0)
    log(f"[9 main] device stage {stage_fps:.1f} frames/s over {MAIN_FRAMES} frames")

    torch.cuda.reset_peak_memory_stats(dev)
    res, la = _drive("a eval_episode auto",
                     lambda: eval_episode(vae, critic, frames, gt, threshold=50, **kw),
                     ("diff_mask", "bilateral_build"), MAIN_FRAMES)
    peak = torch.cuda.max_memory_allocated(dev)
    _profile("a", lambda: eval_episode(vae, critic, frames, gt, threshold=50, **kw))
    log(f"[9 main a] bf16, chunk {MAIN_BATCH}, threshold 50, device CRF (B2 bf16): thr_iou "
        f"{res.thr_iou}, crf_iou {res.crf_iou}; peak memory {peak / 2**30:.3f} GiB")
    require(res.preds.shape == (MAIN_FRAMES,) and np.isfinite(res.preds).all(), "bad preds")
    require(np.isfinite(preds.cpu().numpy()).all(), "non-finite device-stage preds")
    require(res.diff_u8.shape == (MAIN_FRAMES, 64, 64), "bad diff_u8 shape")
    require(res.thr_masks.shape == res.crf_masks.shape == (MAIN_FRAMES, 64, 64), "bad masks")
    require(0.0 <= res.thr_iou <= 1.0 and 0.0 <= res.crf_iou <= 1.0, "IoU out of range")
    paths = {"a": la}

    threshold_sweep(vae, critic, *warm, **kw)  # warm-up
    sweep, paths["b"] = _drive("b threshold_sweep auto",
                               lambda: threshold_sweep(vae, critic, frames, gt, **kw),
                               ("diff_mask", "bilateral_build"), MAIN_FRAMES)
    _profile("b", lambda: threshold_sweep(vae, critic, frames, gt, **kw))
    log(f"[9 main b] {len(sweep)} thresholds: {sweep}")
    require(len(sweep) == SWEEP_T and all(0.0 <= r["thr_iou"] <= 1.0 and 0.0 <= r["crf_iou"]
                                          <= 1.0 for r in sweep), "bad sweep results")
    at50 = next(r for r in sweep if r["threshold"] == 50)
    require(at50["thr_iou"] == res.thr_iou, "sweep thr_iou at 50 differs from eval_episode's")

    for key, build, kernels in (("c", "int8", ("diff_mask", "kernel_i8_build", "matvec_i8")),
                                ("d", "vmem", ("diff_mask", "mean_field_resident"))):
        with crf_build(build):
            eval_episode(vae, critic, *warm, threshold=50, **kw)  # warm-up
            got, paths[key] = _drive(
                f"{key} eval_episode {build}",
                lambda: eval_episode(vae, critic, frames, gt, threshold=50, **kw),
                kernels, MAIN_FRAMES)
            _profile(key, lambda: eval_episode(vae, critic, frames, gt, threshold=50, **kw))
        agree = float(np.mean(got.crf_masks == res.crf_masks))
        log(f"[9 main {key}] crf_iou {got.crf_iou}; masks identical to the default build's "
            f"{agree:.6f} (bar 0.999)")
        require(agree >= 0.999, f"{build}: mask agreement {agree}")
        require(got.thr_iou == res.thr_iou, f"{build}: thr_iou differs")

    nv = SWEEP_VMEM_FRAMES
    with crf_build("vmem"):
        threshold_sweep(vae, critic, *warm, **kw)  # warm-up
        sweep_v, paths["e"] = _drive(
            "e threshold_sweep vmem",
            lambda: threshold_sweep(vae, critic, frames[:nv], gt[:nv], **kw),
            ("diff_mask", "mean_field_resident"), nv)
        _profile("e", lambda: threshold_sweep(vae, critic, frames[:nv], gt[:nv], **kw))
    log(f"[9 main e] {sweep_v}")
    # the same 13 mask sets of the first nv frames, refined by both builds
    diff = torch.from_numpy(res.diff_u8[:nv]).to(dev)
    masks = threshold_masks(diff, torch.tensor(DEFAULT_SWEEP, device=dev))
    want = refine_masks_multi_device(frames_dev[:nv], masks, fetch=False)
    got = refine_masks_multi_device(frames_dev[:nv], masks, build="vmem", fetch=False)
    agree = [float((got[t] == want[t]).double().mean()) for t in range(SWEEP_T)]
    log(f"[9 main e] refined mask sets identical to the default build's: min {min(agree):.6f} "
        f"(bar 0.999)")
    require(min(agree) >= 0.999, f"vmem sweep mask agreement {agree}")
    return {name: sum(p[name] for p in paths.values()) for name in la}


def _u8_thr(out):
    from critic_vae_tpu_torch.ops.mask import normalize_diffs

    u8, _ = normalize_diffs(out["diff"], out["max_value"])
    return u8, u8 > 50


def phase_front_end(dev, critic, vae):
    """Each front-end formulation against split, then their bf16 rates and
    the default stage's kernels."""
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.device import cuda_ms
    from critic_vae_tpu_torch.ops.mask import episode_forward

    frames, _ = generate_frames(FRONT_FRAMES, seed=9)
    fr = torch.from_numpy(frames).to(dev)

    def agreement(out, base):
        (u8, thr), (bu8, bthr) = _u8_thr(out), _u8_thr(base)
        return ((out["preds"] - base["preds"]).abs().max().item(),
                ((u8.int() - bu8.int()).abs() <= 1).double().mean().item(),
                (thr == bthr).double().mean().item())

    with no_tf32():
        split32 = episode_forward(vae, critic, fr, compute_dtype="float32", front_end="split")
        for name, kw in FRONT_ENDS.items():
            err, within1, same = agreement(
                episode_forward(vae, critic, fr, compute_dtype="float32", **kw), split32)
            log(f"[10 front end] {name} vs split, float32, TF32 off: preds max_abs_err "
                f"{err:.3e} (bar 1e-4); diff_u8 within 1 level {within1:.6f} (bar 0.999); "
                f"thr masks identical {same:.6f} (bar 0.998)")
            require(err <= 1e-4 and within1 >= 0.999 and same >= 0.998,
                    f"front end {name} float32 misses a bar")
    # bf16: the preds are held to BF16_PRED_BAR; the diff maps, differences of
    # two bf16 decodes, move with any change of rounding, so each formulation's
    # maps and masks are held to bf16's own noise floor: no further from split
    # bf16 than split bf16 is from split float32
    split16 = episode_forward(vae, critic, fr, compute_dtype="bfloat16", front_end="split")
    _, floor_within1, floor_same = agreement(split16, split32)
    log(f"[10 front end] noise floor, split bf16 vs split float32: diff_u8 within 1 level "
        f"{floor_within1:.6f}; thr masks identical {floor_same:.6f}")
    for name, kw in FRONT_ENDS.items():
        err, within1, same = agreement(
            episode_forward(vae, critic, fr, compute_dtype="bfloat16", **kw), split16)
        log(f"[10 front end] {name} vs split, bfloat16: preds max_abs_err {err:.3e} (bar "
            f"{BF16_PRED_BAR:.3e}); diff_u8 within 1 level {within1:.6f} (bar "
            f"{floor_within1:.6f}); thr masks identical {same:.6f} (bar {floor_same:.6f})")
        require(err <= BF16_PRED_BAR, f"front end {name} bfloat16: preds error {err}")
        require(within1 >= floor_within1 and same >= floor_same,
                f"front end {name} bfloat16: maps or masks below the bf16 noise floor")
    for name, kw in (("split", dict(front_end="split")), ("auto (merged)", {}),
                     *FRONT_ENDS.items()):
        ms = cuda_ms(lambda: episode_forward(vae, critic, fr, compute_dtype="bfloat16", **kw),
                     iters=10)
        log(f"[10 front end] {name}: device stage {FRONT_FRAMES / ms * 1e3:.1f} frames/s "
            f"({ms:.4f} ms per {FRONT_FRAMES}-frame chunk, bf16)")
    reps = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        for _ in range(reps):
            episode_forward(vae, critic, fr, compute_dtype="bfloat16")
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels)
    log(f"[10 front end] profile of the default stage (bf16, chunk {FRONT_FRAMES}): "
        f"{total / reps / 1e3:.4f} ms of kernels per chunk")
    for e in kernels[:14]:
        log(f"[10 front end]   {e.self_device_time_total / reps / 1e3:9.4f} ms "
            f"{e.self_device_time_total / max(total, 1):6.1%}  x{e.count // reps:<3d} {e.key[:110]}")
    # which convs: device time of each conv call (its layout transforms
    # included) by input and weight shape
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::convolution"]
    convs.sort(key=lambda e: e.device_time_total, reverse=True)
    for e in convs:
        log(f"[10 front end]   conv {e.device_time_total / reps / 1e3:9.4f} ms "
            f"{e.device_time_total / max(total, 1):6.1%}  x{e.count // reps:<3d} input "
            f"{e.input_shapes[0]} weight {e.input_shapes[1]}")


def phase_p1(dev):
    """Probe P1 through its entry path, then each question's kernel against
    its plain version."""
    import torch

    from critic_vae_tpu_torch.device import cuda_ms, device_ms
    from critic_vae_tpu_torch.kernels import build as kb
    from critic_vae_tpu_torch.probes import caps_probe as p1

    torch.cuda.synchronize()
    kb.reset_launches()
    res = p1.run(dev)
    torch.cuda.synchronize()
    launches = kb.LAUNCHES["caps_probe"]
    for key, how in p1.INSTRUCTIONS.items():
        log(f"[11 P1 caps_probe] {key}: {res[key]} -- {how}")
    require(all(res[k] is True for k in p1.INSTRUCTIONS), f"P1 answers {res}")
    require(launches >= 3, f"P1: {launches} launches")
    x1, x2, x3, w3 = p1.probe_inputs(dev)
    # (kernel, plain version, the kernel's name in csrc/caps_probe.cu)
    questions = (
        (lambda: p1.q1_lane_offset_write(x1), lambda: p1.q1_reference(x1), "q1_lane_offset_write"),
        (lambda: p1.q2_phase_max_40(x2), lambda: p1.q2_reference(x2), "q2_phase_max"),
        (lambda: p1.q3_fori_dyn_dot(x3, w3), lambda: p1.q3_reference(x3, w3), "q3_loop_dyn_dot"))
    # the questions are launch-bound: the yardstick is a kernel that does nothing
    empty_ms = device_ms(lambda: p1.empty_launch(dev), "empty_kernel")
    errs, ms, call_ms, plain_ms = [], 0.0, 0.0, 0.0
    for q, (kern, plain, name) in enumerate(questions, 1):
        k, r = kern(), plain()
        torch.cuda.synchronize()
        errs.append((k - r).abs().max().item())
        scale = r.abs().max().item()
        bar = 0.0 if q < 3 else 1e-5 * scale
        k_ms, c_ms = device_ms(kern, name), cuda_ms(kern, iters=50)
        p_ms = cuda_ms(plain, iters=50)
        ms, call_ms, plain_ms = ms + k_ms, call_ms + c_ms, plain_ms + p_ms
        log(f"[11 P1 caps_probe] Q{q} kernel vs plain: max_abs_err {errs[-1]:.3e} (bar "
            f"{bar:.3e}); device {k_ms:.4f} ms (an empty kernel {empty_ms:.4f} ms), call "
            f"{c_ms:.4f} ms, plain {p_ms:.4f} ms")
        require(errs[-1] <= bar, f"P1 Q{q}: error {errs[-1]}")
    # Q1 and Q2 in and out in f32; Q3 reads only its 4 frames' 32 rows of x
    rows3 = p1.FRAMES * p1.FRAME_ROWS
    nbytes = (128 * 20 + 128 * 128) * 4 + (128 * 160 + 128 * 40) * 4 + (
        rows3 * 128 * 2 + 128 * 160 * 2 + rows3 * 160 * 4)
    return {"launches": launches, "max_abs_err": max(errs), "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, **bound(nbytes, [(2 * rows3 * 128 * 160, BF16_FLOPS)]),
            "library_ms": None, "empty_ms": empty_ms}


def _p2_agreement(k, r):
    """P2's bf16 output against the plain version's: the share within one
    bf16 ulp or 1e-5 (NaN where both are NaN counts as equal), the max abs
    error and the max ulp distance over the finite entries."""
    import torch

    ulps = (k.view(torch.int16).int() - r.view(torch.int16).int()).abs()
    diff = (k.float() - r.float()).abs()
    both_nan = torch.isnan(k) & torch.isnan(r)
    ok = ((ulps <= 1) | (diff <= 1e-5) | both_nan).double().mean().item()
    fin = torch.isfinite(k.float()) & torch.isfinite(r.float())
    return ok, diff[fin].max().item(), ulps[fin].max().item()


def phase_p2(dev, critic, vae):
    """Probe P2 through its entry path, then the kernel against its plain
    version at B=1024 and against the s2d phase conv on real frames."""
    import torch
    import torch.nn.functional as F

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.device import cuda_ms
    from critic_vae_tpu_torch.kernels import build as kb
    from critic_vae_tpu_torch.ops.mask import merged_conv0_weight
    from critic_vae_tpu_torch.probes import copy_floor_probe as p2

    torch.cuda.synchronize()
    kb.reset_launches()
    res = p2.run(dev)
    torch.cuda.synchronize()
    launches = kb.LAUNCHES["front_end_probe"]
    log(f"[12 P2 copy_floor_probe] B={res['frames']} F={res['frames_per_block']}: dot_only "
        f"{res['dot_only_ms']:.4f} ms, copies_and_dot {res['copies_and_dot_ms']:.4f} ms, "
        f"copy_floor {res['copy_floor_ms']:.4f} ms ({res['ns_per_bulk_copy']:.4f} ns per "
        f"frame's bulk copy; {res['ns_per_copy']:.6f} ns per im2col block copy of the TPU "
        f"probe's count, {res['copies_per_batch']}, which this kernel does not make), "
        f"{launches} launches")
    log(f"[12 P2 copy_floor_probe] from NCHW bf16 frames: fused path (s2d packing + kernel) "
        f"{res['fused_path_ms']:.4f} ms, library path (s2d packing, cuDNN s2d conv, phase "
        f"max, ReLU) {res['library_path_ms']:.4f} ms; the port's cuDNN merged front end "
        f"(full-resolution conv, biases, float32 BN, pools: more work) "
        f"{res['cudnn_front_end_ms']:.4f} ms")
    require(launches > 0, "P2: the probe launched no kernel")
    b = p2.FRAMES
    x, w = p2.probe_inputs(b, dev)
    err = 0.0
    for copies in (True, False):
        r = p2.front_end_probe_reference(x, w, copies=copies)
        for fpb in (2, 4, 8):
            k = p2.front_end_probe(x, w, frames_per_block=fpb, copies=copies)
            torch.cuda.synchronize()
            ok, diff, ulps = _p2_agreement(k, r)
            err = max(err, diff)
            log(f"[12 P2 copy_floor_probe] {'copies_and_dot' if copies else 'dot_only'} B={b} "
                f"F={fpb} vs plain: within 1 bf16 ulp (or 1e-5) {ok:.8f} (bar 1), max_abs_err "
                f"{diff:.3e}, max {ulps} ulp")
            require(ok == 1.0, f"P2 copies={copies} F={fpb}: {ok} of outputs within the bar")
            del k
        del r
    # +Inf in the first s2d scanline of every odd frame: it sits right after
    # the even frame's last window, where the K pad's window reads land
    xi = x.clone().view(b, p2.S2D_ROWS, p2.S2D_C)
    xi[1::2, :p2.S2D_SIDE] = float("inf")
    xi = xi.view(-1, p2.S2D_C)
    k, r = p2.front_end_probe(xi, w), p2.front_end_probe_reference(xi, w)
    torch.cuda.synchronize()
    same_nan = torch.equal(torch.isnan(k), torch.isnan(r))
    ok, diff, ulps = _p2_agreement(k, r)
    rows = torch.isfinite(r.float()).all(dim=1)
    kept = torch.isfinite(k.float())[rows].all().item()
    log(f"[12 P2 copy_floor_probe] +Inf in odd frames' first scanline: NaN positions equal to "
        f"the plain version's {same_nan} ({int(torch.isnan(r).sum())} NaN); elsewhere within "
        f"1 bf16 ulp (or 1e-5) {ok:.8f} (bar 1); the {int(rows.sum())} rows the plain version "
        f"leaves finite all finite {kept}")
    require(same_nan and ok == 1.0 and kept, "P2: the +Inf run differs from the plain version")
    del xi, k, r
    plain_ms = cuda_ms(lambda: p2.front_end_probe_reference(x, w), iters=3, warmup=1)
    xs = x.view(b, p2.S2D_SIDE, p2.S2D_SIDE, p2.S2D_C).permute(0, 3, 1, 2)
    w3 = w[:p2.PATCH].view(3, 3, p2.S2D_C, p2.N).permute(3, 2, 0, 1).contiguous()
    library_ms = cuda_ms(lambda: F.conv2d(xs, w3), iters=10)
    log(f"[12 P2 copy_floor_probe] plain {plain_ms:.4f} ms; library (cuDNN s2d 3x3 conv, "
        f"12->160, the product without the phase max and ReLU) {library_ms:.4f} ms")
    frames, _ = generate_frames(8, seed=7)
    fr = (torch.from_numpy(frames).to(dev).float() / 255.0).to(torch.bfloat16)
    fr = fr.permute(0, 3, 1, 2)
    wm = merged_conv0_weight(vae, critic).to(torch.bfloat16)
    xo, wo = p2.pack_frames(fr), p2.pack_weights(wm)
    k = p2.front_end_probe(xo, wo)
    with no_tf32():
        ref = p2.pooled_phase_relu(fr.float(), wm.float())
    torch.cuda.synchronize()
    real_diff = (k.float() - ref).abs()
    share = (real_diff <= 2.0 ** -8 * ref.abs() + 1e-5).double().mean().item()
    real_err = real_diff.max().item()
    log(f"[12 P2 copy_floor_probe] 8 real frames, merged 3->40 weights: kernel vs ReLU of "
        f"the phase max of s2d_conv_pool2_phases (f32): within 2^-8 relative + 1e-5 "
        f"{share:.8f} (bar 1), max_abs_err {real_err:.3e}")
    require(share == 1.0, f"P2 real-data check: {share}")
    # the function's product is (B·1024, 108) @ (108, 160): the slab's
    # columns 108..127 and w's rows there are zero padding
    nbytes = x.numel() * 2 + p2.PATCH * p2.N * 2 + b * p2.OUT_ROWS * p2.PHASE_C * 2
    return {"launches": launches, "max_abs_err": err,
            "ms": res["copies_and_dot_ms"], "plain_ms": plain_ms,
            **bound(nbytes, [(2 * b * p2.OUT_ROWS * p2.PATCH * p2.N, BF16_FLOPS)]),
            "library_ms": library_ms,
            **{k: res[k] for k in ("dot_only_ms", "copy_floor_ms", "fused_path_ms",
                                   "library_path_ms", "cudnn_front_end_ms")}}


def b1_bound(itemsize: int) -> dict:
    """B1's bound at the main path's (2 x 512, 3, 64, 64) decode of
    ``itemsize``-byte values: the decode read once, the f32 grey and maxima
    written once; two tanh, a difference and the grey's FMAs a channel."""
    pix = MAIN_BATCH * NPIX
    return bound(2 * 3 * pix * itemsize + pix * 4 + MAIN_BATCH * 4, [(pix * 19, F32_FLOPS)])


def crf_bounds():
    """Bounds of B1-B5 at the shapes their phases time: B1 at (512, 3, 64,
    64) bf16; B2-B5 at C=64 frames of N=4096 pixels; B4 with L=2; B5 with 10
    iterations at T=1 and T=13."""
    c, n = CRF_CHUNK, NPIX
    b1 = b1_bound(2)
    # the n(n - 1)/2 distinct entries of the symmetric K, each one exp
    build = (c * n * (n - 1) // 2 * ENTRY_OPS, F32_FLOPS)
    b2 = bound(c * n * 3 + c * n * n * 2, [build])
    b3 = bound(c * n * 3 + c * n * n + c * n * 4, [build])
    b4 = bound(c * n * n + 2 * c * n * 2 * 4, [(2 * c * n * n * 2, BF16_FLOPS)])

    def b5(t, iters=10):  # frames, probabilities in and out (the < 1 KB taps left out)
        return bound(c * n * 3 + 2 * c * n * 2 * t * 4,
                     [build, (iters * 2 * c * n * n * 2 * t, BF16_FLOPS)])

    t13 = b5(SWEEP_T)
    return b1, b2, b3, b4, {**b5(1), "bound_ms_t13": t13["bound_ms"],
                            "bound_by_t13": t13["bound_by"]}


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
    b3 = phase_b3(dev)
    b4 = phase_b4(dev)
    b5 = phase_b5(dev)
    from critic_vae_tpu_torch.io.weights import synthetic_models

    critic, vae = synthetic_models(dev)
    phase_golden(dev, critic, vae)
    launches = phase_main(dev, critic, vae)
    phase_front_end(dev, critic, vae)
    p1 = phase_p1(dev)
    p2 = phase_p2(dev, critic, vae)
    bounds = dict(zip(("b1", "b2", "b3", "b4", "b5"), crf_bounds()))

    kernels = [
        {"name": "diff_mask", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/diff_mask.cu",
         "replaces": "critic_vae_tpu/ops/pallas_kernels.py:74",
         "launches": launches["diff_mask"], **b1, **bounds["b1"], "library_ms": None},
        {"name": "bilateral_build", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/bilateral_build.cu",
         "replaces": "critic_vae_tpu/crf/fused_build.py:97",
         "launches": launches["bilateral_build"], **b2, **bounds["b2"], "library_ms": None},
        {"name": "kernel_i8_build", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/kernel_i8_build.cu",
         "replaces": "critic_vae_tpu/crf/fused_build.py:195",
         "launches": launches["kernel_i8_build"], **b3, **bounds["b3"], "library_ms": None},
        {"name": "matvec_i8", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/matvec_i8.cu",
         "replaces": "critic_vae_tpu/crf/fused_build.py:258",
         "launches": launches["matvec_i8"], **b4, **bounds["b4"], "library_ms": None},
        {"name": "mean_field_resident", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/mean_field_resident.cu",
         "replaces": "critic_vae_tpu/crf/fused_resident.py:226",
         "launches": launches["mean_field_resident"], **bounds["b5"], **b5},
        {"name": "caps_probe", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/caps_probe.cu",
         "replaces": "examples/mosaic_caps_probe.py:33", **p1},
        {"name": "front_end_probe", "route": "cuda",
         "source": "critic_vae_tpu_torch/csrc/front_end_probe.cu",
         "replaces": "examples/mosaic_copy_floor_probe.py:37", **p2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
