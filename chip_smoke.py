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
   scalar-load instantiation) in f32 and in bf16 (tanh of the widened
   decode in float32, what both JAX tails compute as XLA compiles them) —
   bar: max abs error <= 1e-6 on grey maps and maxima; then every one of
   the 65,536 bf16 bit patterns in channel 0 of the decode at the critic
   value (16 frames, all else 0, so grey is 0.2989 |tanh| rounded once):
   the kernel against the plain version on the card with NaN positions
   equal, at most 16 values differing and each within 2^-20 relative (a
   few float32 ulps), and within the same relative bar of a CPU torch.tanh
   table. Each dtype's device time (torch.profiler's kernel time over 50
   launches, the inputs in turn over 4 decodes so that they come from HBM,
   not the L2), call time (CUDA events over 50 calls of the Python wrapper)
   and plain time;
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
   rounding);
13. decoder: the phase-split decode (``fused=True``, the default of every
   path above) against the literal repeat-then-conv graph on the card, at
   full width on 512 frames: in float32 with TF32 off the pre-tanh decodes
   within 1e-5 of their largest magnitude and the maps and masks at the f32
   bars; in bf16 the maps and masks no further from the literal bf16 ones
   than literal bf16 is from literal float32 (the noise floor, as in 10);
   then the device stage's ms per 512-frame chunk with each decoder (bf16,
   merged, the median of 7 CUDA-event reps of 10 calls) beside its kernels'
   device time and launches a chunk (torch.profiler);
14. the ``xla`` CRF build (Gram form, float32) on the card: at 64x64 its
   masks >= 99.9% identical to B2's; at a ragged 20x20 ``auto`` resolves to
   ``xla`` on CUDA and its masks are >= 99.9% the CPU run's;
15. the host CRF: its g++ build on this machine, then ``eval_episode`` with
   ``crf_backend="host"`` over 512 synthetic frames in bf16 (frames/s), its
   masks' agreement with the device CRF's recorded (no bar);
16. the CLI: ``python -m critic_vae_tpu_torch video`` on a 48-frame synthetic
   episode with ``--encoder/--decoder`` artifacts written here in the JAX
   package's zip layout, once plain and once with nonzero FiLM params, a
   ``.pt`` critic written by ``torch.save`` and ``--crf-params``: exit code
   0, the thr_iou/crf_iou lines, ``bin_info_vae1.txt`` under ``--root``, and
   without Pillow the line that says no GIF is written (with Pillow, the
   GIF);
17. bf16 against the JAX package: for each seed of
   tests/golden/torch_slice_golden_bf16.npz (seeds 0 and 1: the frames and
   ``numpy_vae_params``), ``eval_episode`` in bf16 on the card (B2 CRF)
   against the JAX package's bf16 run on the CPU — preds within 2^-6, uint8
   maps within one level >= 55%, threshold masks >= 98%, CRF masks >= 99%,
   thr and CRF IoU within 0.002 (BF16_GOLDEN_BARS) — and, recorded beside
   it, the CPU port's run of the same inputs against the golden and the
   card's against the CPU port's. cuDNN's bf16 convs sum in another order
   than XLA:CPU's or PyTorch's CPU conv, which moves a bf16 result by an
   ulp, and the diff maps amplify that: on an H100 the card lay as far from
   the CPU port (68% and 54% of maps within one level) as from JAX (71%,
   58%), while the CPU port lay within 88% and 84% of JAX. The bars lie
   below the card's readings and above those of the port's bf16 arithmetic
   before C.6 (48% and 38%), which this phase was run on once (PERF.md);
18. (a) the ``--quality`` chain (LayerCAM at block 1, lanczos3, {id, mirror}
   x {0, +-2 px} TTA, threshold 64) in float32 on the 64 frames of
   tests/golden/torch_saliency_golden.npz (``make_torch_slice_golden.py
   saliency``), TF32 off in the saliency stage, and the CAM-tuned CRF
   132,32,3.1,8,1.8,10 through B2 in float32 — preds <= 1e-4, maps >= 99.9%
   within one level, threshold masks >= 99.8%, CRF masks >= 99.9%, IoUs
   within 0.001: the float32 bars of phase 8;
19. (b) the saliency stage (``episode_forward(mask_source="saliency")``)
   per 512-frame chunk for gradient, LayerCAM, LayerCAM with the 6 TTA views
   and SmoothGrad n=8, each with its largest kernels (torch.profiler);
20. (c) a main path: ``eval_episode`` on the ``--quality`` chain over the
   2048 frames of phase 9 (device CRF, B2 bf16) with the launch counts set
   to 0 just before it and read just after (B2 launched, B1 not), its
   frames/s and kernels; then ``python -m critic_vae_tpu_torch video
   --quality`` on a 48-frame episode (exit 0, the IoU lines);
21. (d) a main path: ``crf_param_search`` on the golden's 2x2 grid (w1 x
   alpha) and threshold masks, launch counts read around it — each
   combination's masks >= 99.9% as the JAX package's, and its winner unless
   JAX's top two scores lie within 0.001; then the default 27-combination
   grid over 512 frames of 20's masks (launches read too) and its time per
   combination;
22. (e) a main path: ``densecrf_device`` labels and ``soft`` at L = 2 and
   3 through B2, B3 + B4 and B5 (L = 2; L = 3 falls back to B2), launch
   counts read around it, against the card's ``xla`` float32 build — the
   largest marginal gap printed, labels and the argmax of the marginals
   >= 99.9% equal; then B4's 3-lane instance (first launched by
   ``int8`` at L = 3) against ``matvec_i8_reference`` at C = 4 and 64 —
   bar: relative error <= 1e-5, as phase 6;
23. the train golden: 3 float32 train steps (TF32 off) at full width from
   ``numpy_vae_params(0)`` on the 16 frames and with the reparametrize draws
   of tests/golden/torch_train_golden.npz (``make_torch_slice_golden.py
   train``: the JAX package's train step on the CPU) — per-step total and
   recon losses within 1e-5 relative, kld within 1e-4, BN running variances
   within 1e-4 relative and means within 1.5 lr, parameter changes at 64
   seeded positions a leaf within 0.25 lr (the encoder's conv biases, moved
   by Adam on float noise, within 2 lr a step); then a step on a batch with
   a NaN frame: parameters, Adam's state and BN stats bitwise unchanged,
   the guard's counters and the step advanced;
24. training throughput: the multi-step loop at full width, batch 128,
   on a device-resident uint8 dataset of 2048 frames, 200 steps in chunks
   of 50 after a warm-up, in float32 (TF32 off) and bfloat16: frames/s,
   peak memory, the loss falling (the mean of the last 20 steps under the
   first 20's), the share of the operations bound (the step's FLOPs from
   the shapes over 67 TFLOP/s f32 or 989 TFLOP/s bf16), and a
   torch.profiler kernel list of 10 more steps with the device's idle share
   and the launches a step;
25. the commands, in this process through the port's ``main``: ``train
   --source synthetic:2:256 --epochs 1 --batch-size 128`` (exit 0, a
   checkpoint, the artifacts), the same again (it resumes and takes no
   step); ``eval``, ``inject --values 0,0.5,1`` and ``evalsecond`` on PNGs
   of the 16 frames of tests/golden/torch_slice_golden.npz with
   ``numpy_vae_params(0)`` artifacts under ``--root`` — eval's and
   evalsecond's maps (the strips' 4th panel) >= 99.9% within one level of
   the golden's (without Pillow these three are not run, and say so); then
   ``evaluate_images`` over 1024 + 16 frames as a main path (launch counts
   set to 0 just before and read just after: B1 once a 512-frame chunk),
   the 16 frames' maps >= 99.9% within one level and preds within 1e-4 of
   the golden's, and B1 against its plain version on eval's float32 decodes
   (2 x 512 and 2 x 16 frames) — bar: max abs error <= 1e-6;
26. mask distillation: ``build_pseudo_masks`` on the 32 frames of
   tests/golden/torch_distill_golden.npz (``make_torch_slice_golden.py
   distill``) — LayerCAM threshold masks >= 99.8% and the CRF masks through
   B2 in bf16 >= 99.9% identical to the JAX package's float32 masks; then
   as a main path over 8,192 synthetic frames (launch counts set to 0 just
   before and read just after: B2 once a 64-frame chunk, 128 launches, B1
   never), its frames/s without the CRF and of the CRF part alone, and the
   CAM health; 3 float32 train steps with ``mask_distill=0.5`` at full width
   against the golden's at phase 23's bars (``md_loss`` within 1e-5
   relative), on cuDNN's deterministic algorithms (the term turns the
   default backward's run-to-run drift into step 3's loss errors of up to
   1.2e-05 total, 3.5e-05 md and 1.0e-04 kld over 3 runs); the multi-step loop with the term at batch 128 on 2,048 of
   those frames and their masks, 4 windows of 50 steps (median, spread,
   idle share, launches a step, the loss falling), beside phase 24's float32
   run; ``train --mask-distill 0.3 --source synthetic:2:256 --epochs 1``
   through ``main`` (exit 0);
27. critic training: 3 steps of the critic's step (batch 128, dropout 0.3
   with the JAX package's masks) against tests/golden/torch_critic_golden.npz
   (``make_torch_slice_golden.py critic``) — losses within 1e-5 relative,
   parameters within 0.25 lr; ``train_critic`` for one epoch of 100 steps on
   12,800 synthetic frames (``traincritic``'s default), then the critic's
   multi-step loop over one epoch as 4 windows of 25 steps (median, spread,
   idle share, launches a step, the loss falling); ``critic_cam_health`` of
   the synthetic critic on the golden's 128 frames, every field within 1e-3
   of the JAX package's; ``traincritic --synthetic-frames 1024 --epochs 2
   --cam-select 2`` through ``main`` (exit 0) and its ``.npz`` reloaded;
28. data and export: ``dataset --source synthetic:2:256``, ``second --epochs
   1`` and (with Pillow) ``evalsecond`` on its ``vae2_*`` artifacts through
   ``main`` (exit 0 each); ``build_recon_dataset``'s frames/s over 8
   synthetic trajectories of 1024 frames; ``export`` of the encoder, decoder
   and critic, each ``torch.load(weights_only=True)`` bitwise equal to the
   source's state dict; ``python -m critic_vae_tpu_torch export`` of a FiLM
   decoder exits 1 with the JAX package's refusal;
29. ranks and the trace: on a 512-frame episode with ``numpy_vae_params(0)``
   written as the JAX package's artifacts under a root R, in bf16: (d)
   ``video --root R``, which finds its episode and weights under R (C.8;
   the device CRF, ``auto``), the unmeshed reference; (a) ``video
   --profile DIR`` with the same files given explicitly: one trace under
   DIR naming B1 (``diff_mask``) and B2 (``bilateral_build``) as spans and
   their kernels, the same IoU lines; (b) ``python -m
   torch.distributed.run --standalone --nproc-per-node 1 -m
   critic_vae_tpu_torch video --num-devices 1``: one rank on NCCL, its
   ``multi-host``/``sharding`` lines, the same IoU lines and a
   byte-identical ``bin_info_vae1.txt``; (c) ``eval_episode`` over the
   2048 frames of phase 9 with a one-rank NCCL mesh formed in this process,
   as a main path (launch counts set to 0 just before and read just after:
   B1, B2), its results identical to the unmeshed run's, then frames/s with
   and without the mesh, 3 reps each, alternating;
30. data-parallel training at full width (critic-synthetic,
   ``numpy_vae_params(0)``, batch 128, float32 with TF32 off, cuDNN's
   deterministic algorithms for the parity parts): (a) a one-rank NCCL mesh
   formed in this process as in 29 (c): 3 steps of ``make_multi_step``
   with and without it from the same state and draws (losses within 1e-6
   relative, and whether bitwise; parameters within 0.25 lr, the encoder's
   conv biases within 2 lr a step), ``make_sharded_multi_step`` at D = 1
   bitwise the meshed loop on the same rows, then 4 windows of 50 steps
   with and without the mesh, alternating: ms a step, launches a step (and
   those the mesh adds), the NCCL kernels' share of the device time
   (torch.profiler), the idle share and the ratio mesh/plain; (b) two
   processes spawned on this card, each forming a gloo group with CUDA
   tensors on cuda:0 (NCCL refuses two ranks on one card): 3 steps of the
   replicated and of the sharded loop (64 rows a rank) against (a)'s
   one-process steps on the equivalent global rows (losses at phase 23's
   bars: total and recon 1e-5 relative, kld 5e-5), both ranks' parameters,
   BN stats and Adam moments bitwise
   equal by ``fetch``; (c) under ``python -m torch.distributed.run
   --nproc-per-node 1`` (one NCCL rank): ``train --device cuda --source
   synthetic:1:1024 --epochs 1 --batch-size 128 --root R`` (its
   ``multi-host`` line, one checkpoint set, one events file and JSONL, the
   two artifacts), the same command again (``resumed from``), then
   ``dataset`` and ``second`` on R.

Phases 26-28 print the card's ``nvidia-smi`` name and power limit beside
their rates.

``python3 chip_smoke.py --parallel-only`` runs phases 1, 2, 29 and 30 alone.
``python3 chip_smoke.py --bf16-golden-only [--port DIR]`` runs phases 1, 2
and 17 alone, driving the critic_vae_tpu_torch package in DIR (for example
an older checkout) against this checkout's goldens.

The second-to-last line is a JSON object with, for each of the seven kernels
(B1-B5, P1, P2), its launches on the paths that run it (phases 9, 11, 12,
20-22, 25, 26 and 29), its error against
its plain version, its times, its bound (the larger of its bytes over the
HBM rate and its operations over the peak rate of their type, from this
run's shapes) and the time of one PyTorch call computing the same function
where there is one (for B5, of its iteration's product; its row also has
build_ms and iter_ms, and each time again at T=13 as *_t13; B4's row has its
3-lane error and time at C=64 as *_l3, its error the larger). B1's and P1's
``ms`` is device time (B1 in bf16, the mask path's dtype) and their
``call_ms`` the time of a call through the
Python wrapper (P1's rows sum the three questions, with ``empty_ms`` the
empty kernel's device time); the other kernels' ``ms`` are CUDA-event times
of calls, which their device time dominates. The last line is {"ok": true,
"device": {...}}. Without CUDA the script fails and prints no result. About
six minutes on an H100, the build (~10 s) included (328.5-363.4 s on an
NVIDIA H100 80GB HBM3 at 700 W, phases 26-28 about a minute of it, phase
29 about 54 s and phase 30 103-121 s, three fifths of that its four
launches of ``torch.distributed.run``).
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
# phase 17's bars, the card's bf16 against the JAX package's on the CPU: below
# the card's readings at both seeds (maps within one level 0.7095 and 0.5767,
# threshold masks 0.9886 and 0.9957, CRF masks 0.9993 and 0.9989) and above
# the port's arithmetic before C.6 (maps 0.4835 and 0.3791, threshold masks
# 0.9748 at seed 0); NVIDIA H100 80GB HBM3, 700 W
BF16_GOLDEN_BARS = {"within1": 0.55, "thr": 0.98, "crf": 0.99, "iou": 2e-3}
# the card's published peaks (H100 SXM, dense): the bounds of the kernels line
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12        # tensor cores
F32_FLOPS = 67e12          # float32 outside the tensor cores
B1_BUFFERS = 4             # B1's timed decodes: 4 x 25.2 MB in turn exceed the 50 MB L2
B1_RAGGED_SIDE = 25        # B1's ragged frames: H*W = 625, no multiple of a 16-byte vector
# float32 operations of one bilateral kernel entry (5 feature differences, 5
# squares, 4 sums, 1 scale, 1 exp): a lower count, as a bound wants
ENTRY_OPS = 16
SALIENCY_GOLDEN = ROOT / "tests" / "golden" / "torch_saliency_golden.npz"
PARALLEL_FRAMES = 512      # phase 29's episode: one chunk
PARALLEL_REPS = 3          # phase 29's timed eval_episode runs, with and without the mesh
# the --quality preset (critic_vae_tpu_torch/cli.py _QUALITY_PRESET); its CRF
# tuple is the golden's crf_params
QUALITY_OPTS = {"method": "layercam", "tta_flip": True, "tta_shift": 2}
QUALITY_THRESHOLD = 64
# phase 19's estimators: the JAX package's default, LayerCAM, the --quality
# stack's 6 views, and its measured-best SmoothGrad (n = 8)
SALIENCY_STAGES = {
    "gradient": {},
    "layercam": {"saliency_method": "layercam"},
    "layercam_tta6": {"saliency_method": "layercam", "saliency_tta_flip": True,
                      "saliency_tta_shift": 2},
    "smoothgrad8": {"saliency_logits": True, "saliency_samples": 8, "saliency_noise": 0.08,
                    "saliency_sigma": 1.0, "saliency_seed": 0},
}
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
    """float32 parity: no TF32 in convs or matmuls, no reduced bf16
    reductions (critic_vae_tpu_torch/device.py::no_tf32)."""
    from critic_vae_tpu_torch.device import no_tf32 as package_no_tf32

    with package_no_tf32():
        yield


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


B1_TANH_REL = 2.0 ** -20  # two float32 tanhs and the product 0.2989·|tanh|: a few ulps


def _b1_tanh_gap(x, y):
    """B1's grey maps x and y of the exhaustive check: (whether their NaN
    positions are equal, how many non-NaN values differ, the largest gap
    relative to y's magnitude (grey is 0.2989 |tanh|, so this is tanh's))."""
    import torch

    same_nan = torch.equal(torch.isnan(x), torch.isnan(y))
    differ = (x != y) & ~torch.isnan(x) & ~torch.isnan(y)
    count = int(differ.sum())
    if not count:
        return same_nan, 0, 0.0
    gap = (x[differ] - y[differ]).abs() / y[differ].abs().clamp_min(2.0 ** -126)
    return same_nan, count, gap.max().item()


def phase_b1(dev):
    """B1 against its plain version in f32 and bf16 at the main path's shape,
    on every bf16 value, and its device, call and plain times."""
    import itertools

    import torch

    from critic_vae_tpu_torch.device import cuda_ms, device_ms
    from critic_vae_tpu_torch.ops.diff_mask import diff_mask, diff_mask_reference

    g = torch.Generator(device=dev).manual_seed(1)
    shape = (2 * MAIN_BATCH, 3, H, W)  # the (2B, 3, H, W) decode
    err, row = 0.0, None
    for dt in (torch.float32, torch.bfloat16):
        # B1_BUFFERS decodes in turn, so a timed launch finds its input out of the L2
        pres = [(2.0 * torch.randn(shape, generator=g, device=dev)).to(dt)
                for _ in range(B1_BUFFERS)]
        # and a ragged 25x25 decode: H*W = 625 is odd, so the planes are not
        # 16-byte aligned and the scalar-load instantiation runs
        ragged = (2.0 * torch.randn((8, 3, B1_RAGGED_SIDE, B1_RAGGED_SIDE), generator=g,
                                    device=dev)).to(dt)
        e = 0.0
        for pre in (pres[0], ragged):
            grey_k, max_k = diff_mask(pre)
            grey_r, max_r = diff_mask_reference(pre)
            torch.cuda.synchronize()
            e = max(e, (grey_k - grey_r).abs().max().item(), (max_k - max_r).abs().max().item())
        err = max(err, e)
        turn = itertools.cycle(pres)
        ms = device_ms(lambda: diff_mask(next(turn)), "diff_mask_kernel")
        call_ms = cuda_ms(lambda: diff_mask(next(turn)), iters=50)
        plain_ms = cuda_ms(lambda: diff_mask_reference(next(turn)), iters=20)
        label = str(dt)[6:]
        b1 = b1_bound(pres[0].element_size())["bound_ms"]
        log(f"[3 B1 diff_mask] {shape} and {tuple(ragged.shape)} {label}: max_abs_err {e:.3e} "
            f"(bar 1e-6); {shape}: device "
            f"{ms:.4f} ms ({b1 / ms:.1%} of its {b1:.4f} ms byte bound), "
            f"call {call_ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(e <= 1e-6, f"B1 {label}: max abs error {e} > 1e-6")
        if dt == torch.bfloat16:  # the mask path's dtype
            row = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms}
        del pres, grey_k, grey_r
    # every bf16 bit pattern in channel 0 of the decode at the critic value,
    # all else 0: grey is exactly 0.2989 |tanh| rounded once, with no
    # FMA-order noise
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    frames = bits.numel() // NPIX
    one = torch.zeros((frames, 3, H, W), dtype=torch.bfloat16)
    one[:, 0] = bits.view(frames, H, W)
    pre_cpu = torch.cat([one, torch.zeros_like(one)])
    pre = pre_cpu.to(dev)
    grey_k, max_k = diff_mask(pre)
    grey_r, max_r = diff_mask_reference(pre)
    grey_c, _ = diff_mask_reference(pre_cpu)  # the CPU's float32 torch.tanh
    torch.cuda.synchronize()
    same_nan, count, gap = _b1_tanh_gap(grey_k, grey_r)
    max_nan, max_count, _ = _b1_tanh_gap(max_k, max_r)
    if count:
        at = torch.nonzero((grey_k != grey_r) & ~torch.isnan(grey_k) & ~torch.isnan(grey_r))
        for f, y, x in at[:16].tolist():
            log(f"[3 B1 diff_mask]   differs at bf16 input {bits.view(frames, H, W)[f, y, x]}: "
                f"kernel {grey_k[f, y, x].item()!r}, plain {grey_r[f, y, x].item()!r}")
    log(f"[3 B1 diff_mask] every bf16 ({bits.numel()} bit patterns, {frames} frames): kernel vs "
        f"plain on the card: NaN positions equal {same_nan and max_nan}, {count + max_count} "
        f"values differ (bar 16), max relative gap {gap:.3e} (bar {B1_TANH_REL:.3e})")
    require(same_nan and max_nan and count + max_count <= 16 and gap <= B1_TANH_REL,
            "B1: the kernel's tanh differs from its plain version's")
    cpu_nan, cpu_count, cpu_gap = _b1_tanh_gap(grey_k.cpu(), grey_c)
    log(f"[3 B1 diff_mask] every bf16: the card's tanh vs a CPU torch.tanh table: NaN "
        f"positions equal {cpu_nan}, {cpu_count} finite values differ (recorded), max "
        f"relative gap {cpu_gap:.3e} (bar {B1_TANH_REL:.3e})")
    require(cpu_nan and cpu_gap <= B1_TANH_REL, "B1: the card's tanh differs from the CPU's")
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
    with no_tf32():
        res = threshold_sweep(vae, critic, frames, gt, tuple(gold["thresholds"].tolist()),
                              device=dev, compute_dtype="float32", crf_backend="device")
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


def _drive(name, fn, kernels, frames, phase="9 main"):
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
    log(f"[{phase} {name}] {frames} frames: {frames / secs:.1f} frames/s ({secs:.3f} s); "
        f"launches {launches}")
    require(all(launches[k] > 0 for k in kernels),
            f"{name}: a kernel of the path was not launched: {launches}")
    return out, launches


def _device_ops(prof, cuda_type=False):
    """The profile's events with device time (with ``cuda_type``, those of
    CUDA type: a profile that also records the host's operations gives
    them their kernels' time), largest first. The port's spans
    (utils/profiling.py::span) also leave device-side ranges in the trace
    (``is_user_annotation``): they cover their operations rather than add
    to them, and torch's own table leaves them out of its totals too."""
    events = [e for e in prof.key_averages() if not e.is_user_annotation
              and (str(e.device_type).endswith("CUDA") if cuda_type
                   else e.self_device_time_total > 0)]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return events


def _profile(key, fn, top=6, phase="9 main"):
    """One more run of a path under torch.profiler: its largest kernels by
    device time."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = _device_ops(prof)
    total = sum(e.self_device_time_total for e in events)
    log(f"[{phase} {key}] profile of one more run: {total / 1e3:.3f} ms of kernels")
    for e in events[:top]:
        log(f"[{phase} {key}]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} "
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
    preds = episode_device_stage(vae, critic, frames_dev, MAIN_BATCH,
                                 compute_dtype="bfloat16")[0]
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
    kernels = _device_ops(prof, cuda_type=True)
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


@contextlib.contextmanager
def literal_decoder(vae):
    """The VAE's decoder as the literal repeat-then-conv graph
    (``fused=False``) for every caller, the pipelines included."""
    dec = vae.decoder
    dec.forward = lambda z, value, apply_tanh=True, fused=True: type(dec).forward(
        dec, z, value, apply_tanh, fused=False)
    try:
        yield
    finally:
        del dec.forward


def phase_decoder(dev, critic, vae):
    """The phase-split decode against the literal graph, then the device
    stage's time with each."""
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.device import cuda_ms
    from critic_vae_tpu_torch.ops.mask import episode_forward

    frames, _ = generate_frames(FRONT_FRAMES, seed=13)
    fr = torch.from_numpy(frames).to(dev)
    z = torch.randn(FRONT_FRAMES, 32, generator=torch.Generator().manual_seed(0)).to(dev)
    v = torch.rand(FRONT_FRAMES, generator=torch.Generator().manual_seed(1)).to(dev)

    def agreement(out, base):
        (u8, thr), (bu8, bthr) = _u8_thr(out), _u8_thr(base)
        return (((u8.int() - bu8.int()).abs() <= 1).double().mean().item(),
                (thr == bthr).double().mean().item())

    with no_tf32(), torch.inference_mode():
        fused = vae.decode(z, v, apply_tanh=False)
        literal = vae.decode(z, v, apply_tanh=False, fused=False)
        rel = ((fused - literal).abs().max() / literal.abs().max()).item()
        fused32 = episode_forward(vae, critic, fr, compute_dtype="float32")
        with literal_decoder(vae):
            literal32 = episode_forward(vae, critic, fr, compute_dtype="float32")
    within1, same = agreement(fused32, literal32)
    log(f"[13 decoder] phase-split vs literal, float32, TF32 off: decode max err {rel:.3e} "
        f"of its largest magnitude (bar 1e-5); diff_u8 within 1 level {within1:.6f} "
        f"(bar 0.999); thr masks identical {same:.6f} (bar 0.998)")
    require(rel <= 1e-5, f"phase-split decode float32 error {rel}")
    require(within1 >= 0.999 and same >= 0.998, "phase-split decode float32 misses a bar")
    fused16 = episode_forward(vae, critic, fr, compute_dtype="bfloat16")
    with literal_decoder(vae):
        literal16 = episode_forward(vae, critic, fr, compute_dtype="bfloat16")
    floor_within1, floor_same = agreement(literal16, literal32)
    within1, same = agreement(fused16, literal16)
    log(f"[13 decoder] noise floor, literal bf16 vs literal float32: diff_u8 within 1 level "
        f"{floor_within1:.6f}; thr masks identical {floor_same:.6f}")
    log(f"[13 decoder] phase-split vs literal, bfloat16: diff_u8 within 1 level {within1:.6f} "
        f"(bar {floor_within1:.6f}); thr masks identical {same:.6f} (bar {floor_same:.6f})")
    require(within1 >= floor_within1 and same >= floor_same,
            "phase-split decode bfloat16: maps or masks below the bf16 noise floor")
    times = {}
    for name in ("phase-split", "literal"):
        with literal_decoder(vae) if name == "literal" else contextlib.nullcontext():
            stage = lambda: episode_forward(vae, critic, fr, compute_dtype="bfloat16")  # noqa: E731
            times[name] = cuda_ms(stage, iters=10, reps=7)
            kernel_ms, launches = _kernel_ms(stage)
        log(f"[13 decoder] {name}: device stage {times[name]:.4f} ms per {FRONT_FRAMES}-frame "
            f"chunk ({FRONT_FRAMES / times[name] * 1e3:.1f} frames/s, bf16, merged; median of "
            f"7 reps of 10 calls, CUDA events); its kernels {kernel_ms:.4f} ms in {launches:.0f} "
            f"launches a chunk (torch.profiler); events - kernels "
            f"{times[name] - kernel_ms:.4f} ms")
    return times


def _kernel_ms(fn, reps: int = 3):
    """(device ms of all kernels per call of ``fn``, kernel launches per
    call), from torch.profiler over ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = _device_ops(prof)
    return (sum(e.self_device_time_total for e in kernels) / reps / 1e3,
            sum(e.count for e in kernels) / reps)


def phase_xla(dev):
    """The Gram-form ``xla`` CRF build on the card."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.device import _resolve_build, refine_masks_device
    from critic_vae_tpu_torch.data.synthetic import generate_frames

    frames, gt = generate_frames(CRF_CHUNK, seed=14)
    noisy = gt ^ (np.random.default_rng(14).random(gt.shape) < 0.08)
    fr, nz = torch.from_numpy(frames).to(dev), torch.from_numpy(noisy).to(dev)
    xla = refine_masks_device(fr, nz, REFERENCE_CRF_PARAMS, build="xla")
    b2 = refine_masks_device(fr, nz, REFERENCE_CRF_PARAMS, build="pallas")
    agree = float(np.mean(xla == b2))
    log(f"[14 xla] 64x64, {CRF_CHUNK} frames: xla (f32 Gram) masks identical to B2's (bf16) "
        f"{agree:.6f} (bar 0.999)")
    require(agree >= 0.999, f"xla build agreement with B2 {agree}")
    side = 20
    frames, gt = generate_frames(16, size=side, seed=15)
    noisy = gt ^ (np.random.default_rng(15).random(gt.shape) < 0.08)
    resolved = _resolve_build("auto", side, side, dev)
    got = refine_masks_device(torch.from_numpy(frames).to(dev), torch.from_numpy(noisy).to(dev),
                              REFERENCE_CRF_PARAMS)
    cpu = refine_masks_device(frames, noisy, REFERENCE_CRF_PARAMS, device="cpu")
    agree = float(np.mean(got == cpu))
    log(f"[14 xla] 20x20 (H*W % 128 != 0): auto resolves to {resolved!r} on CUDA; masks "
        f"identical to the CPU run's {agree:.6f} (bar 0.999)")
    require(resolved == "xla", f"auto at 20x20 on CUDA resolved to {resolved}")
    require(agree >= 0.999, f"ragged xla masks agreement with the CPU {agree}")


def phase_host_crf(dev, critic, vae):
    """The host CRF's build here, then ``eval_episode`` on it."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf import host
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.pipelines.video import eval_episode

    t0 = time.perf_counter()
    lib = host.compile_library()
    log(f"[15 host] {lib.name} built with g++ in {time.perf_counter() - t0:.2f} s")
    n = MAIN_BATCH
    frames, gt = generate_frames(n, seed=16)
    kw = dict(device=dev, batch_size=MAIN_BATCH, compute_dtype="bfloat16")
    eval_episode(vae, critic, frames[:8], gt[:8], crf_backend="host", **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eval_episode(vae, critic, frames, gt, crf_backend="host", **kw)
    secs = time.perf_counter() - t0
    dev_res = eval_episode(vae, critic, frames, gt, crf_backend="device", **kw)
    agree = float(np.mean(res.crf_masks == dev_res.crf_masks))
    log(f"[15 host] eval_episode crf_backend='host', {n} frames bf16: {n / secs:.1f} frames/s "
        f"({secs:.3f} s, {os.cpu_count()} CPU cores); crf_iou {res.crf_iou} (device "
        f"{dev_res.crf_iou}); masks identical to the device CRF's {agree:.6f} (recorded, no bar)")
    require(res.crf_masks.shape == (n, H, W) and res.thr_iou == dev_res.thr_iou,
            "host CRF run malformed")
    return n / secs, agree


def _save_zip_pytree(path, tree):
    """A pytree of numpy arrays in the JAX package's ``save_pytree`` layout:
    a stored zip of '/'-joined ``<path>.npy`` entries."""
    import zipfile

    import numpy as np

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for key, arr in leaves(tree):
            with zf.open(f"{key}.npy", "w") as entry:
                np.lib.format.write_array(entry, arr)


def _run_cli(args, scratch, timeout=300):
    """``python -m critic_vae_tpu_torch video ARGS`` in ``scratch``: (the
    finished process, its seconds)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "critic_vae_tpu_torch", "video", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=scratch,
                          env=env)
    return proc, time.perf_counter() - t0


def phase_cli(dev, scratch: Path):
    """``python -m critic_vae_tpu_torch video`` with JAX-layout artifacts,
    plain and FiLM, a ``torch.save`` critic and ``--crf-params``."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_episode
    from critic_vae_tpu_torch.io import weights

    ep = scratch / "episode"
    generate_episode(str(ep), num_frames=48, seed=17)
    params, state = weights.numpy_vae_params(17)
    film = dict(params["decoder"])
    rng = np.random.default_rng(18)
    for i, co in enumerate((128, 64, 32, 32)):
        film[f"film{i}"] = {"w": rng.normal(0, 0.5, (1, 2 * co)).astype(np.float32),
                            "b": rng.normal(0, 0.2, (2 * co,)).astype(np.float32)}
    crit = weights.load_critic_npz(str(ROOT / "saved-networks" / "critic-synthetic.npz"))
    sd = {}
    for i, key in enumerate(("features.0", "features.3", "features.6", "features.10")):
        sd[f"{key}.weight"] = np.transpose(crit[f"conv{i}_w"], (3, 2, 0, 1))
        sd[f"{key}.bias"] = crit[f"conv{i}_b"]
    sd["features.14.weight"] = np.transpose(crit["conv4_w"], (3, 2, 0, 1))
    sd["features.14.bias"] = crit["conv4_b"]
    for name, key in (("fc0", "crit.1"), ("fc1", "crit.4")):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = crit[f"{name}_w"].T, crit[f"{name}_b"]
    critic_pt = scratch / "critic.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, critic_pt)
    for name, dec in (("plain", params["decoder"]), ("film", film)):
        enc_path, dec_path = scratch / f"{name}_encoder.ckpt", scratch / f"{name}_decoder.ckpt"
        _save_zip_pytree(enc_path, {"params": params["encoder"], "bn_state": state})
        _save_zip_pytree(dec_path, {"params": dec})
        root = scratch / f"root_{name}"
        root.mkdir()
        proc, secs = _run_cli(["--episode", str(ep), "--no-slice", "--encoder", str(enc_path),
                               "--decoder", str(dec_path), "--critic", str(critic_pt),
                               "--crf-params", "44,12,3.1,8,1.8,5", "--root", str(root),
                               "--device", dev.type, "--dtype", "bfloat16"], scratch)
        lines = proc.stdout.splitlines()
        log(f"[16 cli] video --encoder/--decoder ({name}) --critic critic.pt --crf-params: "
            f"exit {proc.returncode} in {secs:.1f} s; " + " | ".join(lines))
        require(proc.returncode == 0, f"video ({name}) failed: {proc.stderr[-2000:]}")
        require(any(ln.startswith("thr_iou=") for ln in lines)
                and any(ln.startswith("crf_iou=") for ln in lines), f"video ({name}): no IoUs")
        backend = "device" if dev.type == "cuda" else "host"
        require(f"crf backend: {backend} (auto)" in lines, f"video ({name}): auto is not {backend}")
        require((root / "bin_info_vae1.txt").is_file(), f"video ({name}): no bin_info")
        try:
            import PIL  # noqa: F401
            pillow = True
        except ImportError:
            pillow = False
        gif = root / "videos" / "video-threshold=50.gif"
        if pillow:
            require(gif.is_file() and f"wrote {gif}" in lines, f"video ({name}): no GIF")
        else:
            require("Pillow is not installed: no GIF is written (as with --no-gif)" in lines
                    and not gif.exists(), f"video ({name}): no Pillow line")
        log(f"[16 cli] {name}: bin_info_vae1.txt written; Pillow "
            f"{'present: GIF written' if pillow else 'absent: the no-GIF line printed'}")


def _bf16_agreement(got, preds, diff_u8, thr, crf, thr_iou, crf_iou) -> dict:
    """How far an ``eval_episode`` result lies from another's arrays."""
    import numpy as np

    return {"preds": float(np.abs(got.preds - preds).max()),
            "within1": float(np.mean(np.abs(got.diff_u8.astype(int) - diff_u8.astype(int)) <= 1)),
            "equal": float(np.mean(got.diff_u8 == diff_u8)),
            "thr": float(np.mean(got.thr_masks == thr)),
            "crf": float(np.mean(got.crf_masks == crf)),
            "thr_iou": abs(got.thr_iou - thr_iou), "crf_iou": abs(got.crf_iou - crf_iou)}


def _meets_bf16_bars(a: dict) -> bool:
    b = BF16_GOLDEN_BARS
    return (a["preds"] <= BF16_PRED_BAR and a["within1"] >= b["within1"] and a["thr"] >= b["thr"]
            and a["crf"] >= b["crf"] and a["thr_iou"] <= b["iou"] and a["crf_iou"] <= b["iou"])


def phase_bf16_golden(dev, critic):
    """The card's bf16 ``eval_episode`` against the JAX package's bf16 runs,
    one a seed of the golden, beside two witnesses of where the gap lies:
    the CPU port's run of the same inputs against the same golden, and the
    card's run against the CPU port's."""
    import copy

    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines.video import eval_episode

    gold = np.load(ROOT / "tests" / "golden" / "torch_slice_golden_bf16.npz")
    cpu = torch.device("cpu")
    critic_cpu = copy.deepcopy(critic).to(cpu)
    b = BF16_GOLDEN_BARS
    bars = (f"bars: preds {BF16_PRED_BAR:.3e}, within 1 level {b['within1']}, thr {b['thr']}, "
            f"crf {b['crf']}, IoU {b['iou']}")
    failed = []
    for i, seed in enumerate(int(s) for s in gold["seeds"]):
        frames, gt = generate_frames(int(gold["num_frames"]), seed=seed)
        vae_cpu = weights.vae_from_params(*weights.numpy_vae_params(seed))
        vae = copy.deepcopy(vae_cpu).to(dev)
        kw = dict(threshold=int(gold["threshold"]), compute_dtype="bfloat16", crf_backend="device")
        card = eval_episode(vae, critic, frames, gt, device=dev, **kw)
        port = eval_episode(vae_cpu, critic_cpu, frames, gt, device=cpu, **kw)
        want = (gold["preds"][i], gold["diff_u8"][i],
                np.unpackbits(gold["thr_bits"][i], axis=-1).astype(bool),
                np.unpackbits(gold["crf_bits"][i], axis=-1).astype(bool),
                float(gold["thr_iou"][i]), float(gold["crf_iou"][i]))
        rows = (("card vs JAX", _bf16_agreement(card, *want)),
                ("CPU port vs JAX", _bf16_agreement(port, *want)),
                ("card vs CPU port", _bf16_agreement(card, port.preds, port.diff_u8,
                                                     port.thr_masks, port.crf_masks,
                                                     port.thr_iou, port.crf_iou)))
        for name, a in rows:
            log(f"[17 bf16 golden] seed {seed}, {len(frames)} frames, {name}: preds max_abs_err "
                f"{a['preds']:.3e}; diff_u8 within 1 level {a['within1']:.6f}, equal "
                f"{a['equal']:.6f}; thr masks identical {a['thr']:.6f}; crf masks identical "
                f"{a['crf']:.6f}; |thr_iou gap| {a['thr_iou']:.4f}, |crf_iou gap| "
                f"{a['crf_iou']:.4f}")
        ok = _meets_bf16_bars(rows[0][1])
        log(f"[17 bf16 golden] seed {seed}: card vs JAX meets the {bars}: {ok}")
        if not ok:
            failed.append(seed)
    require(not failed, f"bf16 golden: seeds {failed} miss a bar")


def _quality_crf():
    """The --quality preset's CRF tuple, as the saliency golden holds it."""
    import numpy as np

    gold = np.load(SALIENCY_GOLDEN)
    p = gold["crf_params"].tolist()
    return (*p[:5], int(p[5]))


def phase_quality_golden(dev, critic, vae):
    """(a) The --quality chain in float32 against the JAX package's on the
    CPU: the saliency stage (TF32 off inside it), threshold 64, the CAM-tuned
    CRF through B2 in float32."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf.device import refine_masks_device
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.ops.iou import iou
    from critic_vae_tpu_torch.pipelines.video import eval_episode

    gold = np.load(SALIENCY_GOLDEN)
    frames, gt = generate_frames(int(gold["num_frames"]), seed=int(gold["seed"]))
    with no_tf32():
        res = eval_episode(vae, critic, frames, gt, device=dev, threshold=int(gold["threshold"]),
                           run_crf=False, compute_dtype="float32", mask_source="saliency",
                           saliency_opts=QUALITY_OPTS)
        crf = refine_masks_device(frames, torch.from_numpy(res.thr_masks).to(dev),
                                  _quality_crf(), compute_dtype="float32", device=dev)
    thr_gold = np.unpackbits(gold["thr_bits"], axis=-1).astype(bool)
    crf_gold = np.unpackbits(gold["crf_bits"], axis=-1).astype(bool)
    pred_err = float(np.abs(res.preds - gold["preds"]).max())
    within1 = float(np.mean(np.abs(res.diff_u8.astype(int) - gold["diff_u8"].astype(int)) <= 1))
    thr_agree = float(np.mean(res.thr_masks == thr_gold))
    crf_agree = float(np.mean(crf == crf_gold))
    crf_iou = iou(gt, crf)
    log(f"[18 quality golden] {len(frames)} frames, --quality chain f32 (LayerCAM, 6 TTA views, "
        f"threshold {int(gold['threshold'])}, CRF {_quality_crf()} by B2 f32): preds max_abs_err "
        f"{pred_err:.3e} (bar 1e-4); maps within 1 level {within1:.6f} (bar 0.999); thr masks "
        f"identical {thr_agree:.6f} (bar 0.998); crf masks identical {crf_agree:.6f} (bar 0.999)")
    log(f"[18 quality golden] thr_iou {res.thr_iou} vs {float(gold['thr_iou'])}; crf_iou "
        f"{crf_iou} vs {float(gold['crf_iou'])} (bar 0.001)")
    require(pred_err <= 1e-4 and within1 >= 0.999, "quality golden: preds or maps miss a bar")
    require(thr_agree >= 0.998 and crf_agree >= 0.999, "quality golden: masks miss a bar")
    require(abs(res.thr_iou - float(gold["thr_iou"])) <= 1e-3
            and abs(crf_iou - float(gold["crf_iou"])) <= 1e-3, "quality golden: IoU differs")
    return frames, gt, thr_gold


def phase_saliency_stage(dev, critic, vae):
    """(b) The saliency stage's ms per 512-frame chunk for each estimator,
    with its largest kernels."""
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.device import cuda_ms
    from critic_vae_tpu_torch.ops.mask import episode_forward

    frames, _ = generate_frames(MAIN_BATCH, seed=19)
    fr = torch.from_numpy(frames).to(dev)
    rows = {}
    for name, kw in SALIENCY_STAGES.items():
        def run():
            return episode_forward(vae, critic, fr, mask_source="saliency", **kw)

        out = run()
        require(out["diff"].shape == (MAIN_BATCH, H, W) and bool(out["diff"].isfinite().all())
                and bool(out["preds"].isfinite().all()), f"saliency stage {name}: bad output")
        ms = cuda_ms(run, iters=5, reps=3)
        rows[name] = ms
        log(f"[19 saliency stage] {name}: {ms:.4f} ms per {MAIN_BATCH}-frame chunk "
            f"({MAIN_BATCH / ms * 1e3:.1f} frames/s; median of 3 CUDA-event reps of 5 calls)")
        _profile(name, run, top=5, phase="19 saliency stage")
    return rows


def phase_quality_main(dev, critic, vae, scratch: Path):
    """(c) ``eval_episode`` on the --quality chain over 2048 frames (what
    ``video --quality`` runs), launch counts read around it; then ``video
    --quality`` itself on a 48-frame episode."""
    import numpy as np

    from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
    from critic_vae_tpu_torch.pipelines.video import eval_episode

    frames, gt = generate_frames(MAIN_FRAMES, seed=0)
    kw = dict(device=dev, batch_size=MAIN_BATCH, threshold=QUALITY_THRESHOLD,
              crf_params=_quality_crf(), crf_backend="auto", mask_source="saliency",
              saliency_opts=QUALITY_OPTS)
    eval_episode(vae, critic, frames[:MAIN_BATCH], gt[:MAIN_BATCH], **kw)  # warm-up
    res, launches = _drive("f eval_episode --quality",
                           lambda: eval_episode(vae, critic, frames, gt, **kw),
                           ("bilateral_build",), MAIN_FRAMES, phase="20 quality")
    _profile("f", lambda: eval_episode(vae, critic, frames, gt, **kw), phase="20 quality")
    log(f"[20 quality f] float32 saliency stage, chunk {MAIN_BATCH}, threshold "
        f"{QUALITY_THRESHOLD}, device CRF (B2 bf16): thr_iou {res.thr_iou}, crf_iou "
        f"{res.crf_iou}; B1 launches {launches['diff_mask']} (the saliency source has no decode)")
    require(launches["diff_mask"] == 0, "the saliency path launched B1")
    require(res.preds.shape == (MAIN_FRAMES,) and np.isfinite(res.preds).all(), "bad preds")
    require(res.thr_masks.shape == res.crf_masks.shape == (MAIN_FRAMES, H, W), "bad masks")
    require(0.0 <= res.thr_iou <= 1.0 and 0.0 <= res.crf_iou <= 1.0, "IoU out of range")
    ep = scratch / "quality_episode"
    generate_episode(str(ep), num_frames=48, seed=20)
    root = scratch / "root_quality"
    root.mkdir()
    proc, secs = _run_cli(["--episode", str(ep), "--no-slice", "--quality", "--no-gif",
                           "--vae-seed", "0", "--root", str(root), "--device", dev.type],
                          scratch)
    lines = proc.stdout.splitlines()
    log(f"[20 quality] video --quality: exit {proc.returncode} in {secs:.1f} s; "
        + " | ".join(lines))
    require(proc.returncode == 0, f"video --quality failed: {proc.stderr[-2000:]}")
    require(any(ln.startswith("thr_iou=") for ln in lines)
            and any(ln.startswith("crf_iou=") for ln in lines), "video --quality: no IoUs")
    return res, launches


def phase_search(dev, frames, gt, thr_gold, res_main, frames_main, gt_main):
    """(d) ``crf_param_search`` on the golden's 2x2 grid and threshold
    masks against the JAX package's, then the default 27-combination grid's
    time per combination over 512 frames."""
    import numpy as np

    from critic_vae_tpu_torch.cli import _parse_crf_grid
    from critic_vae_tpu_torch.crf.device import crf_param_search, refine_masks_device

    gold = np.load(SALIENCY_GOLDEN)
    gold_params = [(*p[:5], int(p[5])) for p in gold["search_params"].tolist()]
    grid = {"w1": sorted({p[0] for p in gold_params}), "alpha": sorted({p[1] for p in gold_params})}
    n = len(frames)
    (best, results), la = _drive("g crf_param_search 2x2",
                                 lambda: crf_param_search(frames, thr_gold, gt, grid, device=dev),
                                 ("bilateral_build",), n, phase="21 search")
    for score, params in results:
        i = gold_params.index(params)
        want = np.unpackbits(gold["search_bits"][i], axis=-1).astype(bool)
        agree = float(np.mean(refine_masks_device(frames, thr_gold, params, device=dev) == want))
        log(f"[21 search] {params}: iou {score:.6f} vs JAX's {gold['search_scores'][i]:.6f}; "
            f"masks identical to JAX's {agree:.6f} (bar 0.999)")
        require(agree >= 0.999, f"search {params}: mask agreement {agree}")
    top = gold["search_scores"]
    same = results[0][1] == gold_params[0]
    log(f"[21 search] winner {results[0][1]} (JAX's {gold_params[0]}; its top two scores "
        f"{top[0]:.6f}, {top[1]:.6f})")
    require(same or top[0] - top[1] <= 1e-3, "search: another winner than JAX's")
    require(best.shape == thr_gold.shape and best.dtype == bool, "search: bad best masks")
    nt = MAIN_BATCH
    grid27 = _parse_crf_grid("")
    combos = int(np.prod([len(v) for v in grid27.values()]))
    args = (frames_main[:nt], res_main.thr_masks[:nt], gt_main[:nt], grid27)
    (_, results27), l27 = _drive(f"h crf_param_search default grid ({combos} combinations)",
                                 lambda: crf_param_search(*args, device=dev),
                                 ("bilateral_build",), nt * combos, phase="21 search")
    t0 = time.perf_counter()
    crf_param_search(*args, device=dev)
    per = (time.perf_counter() - t0) / combos
    log(f"[21 search] default grid over {nt} frames of the --quality masks: {per * 1e3:.2f} ms "
        f"per combination ({nt / per:.1f} frames/s); best {results27[0]}")
    return {k: la[k] + l27[k] for k in la}, per


def phase_densecrf(dev):
    """(e) ``densecrf_device`` labels and ``soft`` through B2, B3 + B4 and
    B5 against the card's ``xla`` float32 build, at L = 2 and 3; then B4's
    3-lane instance against its plain version."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
    from critic_vae_tpu_torch.crf.device import densecrf_device
    from critic_vae_tpu_torch.crf.fused_build import (
        build_kernel_i8,
        matvec_i8,
        matvec_i8_reference,
    )
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.device import cuda_ms

    frames, gt = generate_frames(CRF_CHUNK, seed=22)
    m = (gt ^ (np.random.default_rng(22).random(gt.shape) < 0.08)).astype(np.float32)
    probs = {2: np.stack([1 - m, m], -1), 3: np.stack([1 - m, 0.6 * m, 0.4 * m], -1)}
    p = REFERENCE_CRF_PARAMS
    ref = {L: (densecrf_device(frames, probs[L], p, soft=True, device=dev),
               densecrf_device(frames, probs[L], p, device=dev)) for L in probs}
    builds = ("pallas", "int8", "vmem")
    out = {}

    def run():
        for L in probs:
            for b in builds:
                out[L, b] = (densecrf_device(frames, probs[L], p, soft=True, build=b, device=dev),
                             densecrf_device(frames, probs[L], p, build=b, device=dev))

    _, launches = _drive("i densecrf_device", run,
                         ("bilateral_build", "kernel_i8_build", "matvec_i8",
                          "mean_field_resident"), 2 * len(builds) * 2 * CRF_CHUNK,
                         phase="22 densecrf")
    for (L, b), (q, lab) in out.items():
        gap = float(np.abs(q - ref[L][0]).max())
        agree = float(np.mean(lab == ref[L][1]))
        soft_agree = float(np.mean(q.argmax(-1) == ref[L][0].argmax(-1)))
        kernel = {"pallas": "B2", "int8": "B3 + B4", "vmem": "B5" if L == 2 else "B2"}[b]
        log(f"[22 densecrf] L={L} build {b} ({kernel}), {CRF_CHUNK} frames: largest marginal gap "
            f"to xla f32 {gap:.3e}; labels identical {agree:.6f}, argmax of soft {soft_agree:.6f} "
            f"(bar 0.999)")
        require(q.shape == (CRF_CHUNK, H, W, L) and np.isfinite(q).all(), f"{b} L={L}: bad soft")
        require(agree >= 0.999 and soft_agree >= 0.999, f"{b} L={L}: labels {agree}")
    alpha, beta = p[1:3]
    g = torch.Generator(device=dev).manual_seed(22)
    row = {}
    for c in (4, CRF_CHUNK):
        k8, _ = build_kernel_i8(_crf_imgs(c, 5, dev), alpha, beta, h=H, w=W)
        y = torch.rand((c * NPIX, 3), generator=g, device=dev)
        got = matvec_i8(k8, y, n=NPIX)
        want = matvec_i8_reference(k8, y.to(torch.bfloat16), n=NPIX)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        ms = cuda_ms(lambda: matvec_i8(k8, y, n=NPIX), iters=20)
        log(f"[22 densecrf] B4 matvec_i8 C={c} N={NPIX} L=3 (its 3-lane instance): relative "
            f"error {rel:.3e} (bar 1e-5), max_abs_err {err:.3e}; kernel {ms:.4f} ms")
        require(rel <= 1e-5, f"B4 L=3 C={c}: relative error {rel} > 1e-5")
        row = {"max_abs_err_l3": err, "ms_l3": ms}
        del k8, y, got, want
    return launches, row


# ---------------------------------------------------------------- training

TRAIN_GOLDEN = ROOT / "tests" / "golden" / "torch_train_golden.npz"
TRAIN_BATCH = 128           # the reference's batch (vae_parameters.py)
TRAIN_STEPS = 200           # timed steps a dtype
TRAIN_CHUNK = 50            # steps a dispatch of the multi-step loop, and a timed window
TRAIN_FRAMES = 2048         # the device-resident uint8 dataset of phase 24
TRAIN_GOLDEN_RUNS = 3       # phase 23 repeats its 3 steps from fresh states
EVAL_FRAMES = 1024          # phase 25's in-process eval: two chunks of 512
# phase 23's bars (tests/test_torch_train.py states why): per-step total and
# recon losses within 1e-5 relative; parameter changes within 0.25 lr, the
# encoder's conv biases (zero gradient in exact arithmetic, so Adam moves them
# on float noise) within 2 lr a step; step 1's BN stats (the same parameters)
# within 1e-6, means absolute and variances relative. The kld and, after 3
# steps, the BN variances follow the parameters' drift: cuDNN's float32
# backward sums in other orders than the CPU's (and differs run to run), and
# Adam's first steps turn that noise into moves of up to lr. Their bars are
# about 2x the worst of 12 runs (NVIDIA H100 80GB HBM3, 700 W): kld 1.25e-05
# to 2.35e-05 relative (step 1 alone 4.75e-07), variances 2.04e-05 to
# 2.10e-05; BN means within 1.5 lr after 3 steps
TRAIN_LOSS_REL = {"total_loss": 1e-5, "recon_loss": 1e-5, "kld": 5e-5}
TRAIN_BN_VAR_REL = 5e-5
TRAIN_BN1 = 1e-6            # step 1's BN stats: means absolute, variances relative
ENC_CONV_BIASES = {f"encoder/conv{i}/b" for i in range(4)}


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _bn_errors(bns, gold, suffix=""):
    """(worst absolute error of the running means, worst relative error of
    the running variances) against the golden's ``bn<i>_mean|var<suffix>``."""
    import numpy as np

    mean = max(float(np.abs(bn.running_mean.cpu().numpy() - gold[f"bn{i}_mean{suffix}"]).max())
               for i, bn in enumerate(bns))
    var = max(float(np.abs(bn.running_var.cpu().numpy() / gold[f"bn{i}_var{suffix}"] - 1).max())
              for i, bn in enumerate(bns))
    return mean, var


def _kl_split(vae, x, gold) -> dict:
    """Step 1's kld against JAX's, split: the train-mode encoder's mu and
    logvar against the golden's (same parameters, same frames), the KL's own
    float32 rounding on the card's mu and logvar (against float64 on the
    same tensors), and the card's float64 KL against JAX's float64 KL of its
    own mu and logvar."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.ops.losses import KLD_WEIGHT, kld_loss

    with no_tf32(), torch.no_grad():
        mu, logvar, _ = vae.encode(x, train=True)
    jmu, jlv = (torch.from_numpy(gold[k]).double() for k in ("mu1", "logvar1"))
    card64 = KLD_WEIGHT * kld_loss(mu.double().cpu(), logvar.double().cpu()).item()
    jax64 = KLD_WEIGHT * kld_loss(jmu, jlv).item()
    return {"mu_abs": (mu.double().cpu() - jmu).abs().max().item(),
            "logvar_abs": (logvar.double().cpu() - jlv).abs().max().item(),
            "kl_f32_vs_f64": abs(KLD_WEIGHT * kld_loss(mu, logvar).item() / card64 - 1),
            "kl64_card_vs_jax": abs(card64 / jax64 - 1),
            "kl_jax_f32_vs_f64": abs(float(gold["kld"][0]) / jax64 - 1)}


def _golden_run(state, step, batch, gold, params, masks=None) -> dict:
    """The golden's 3 steps on a fresh ``state`` (``masks``: the batch's
    pseudo-label masks of a ``mask_distill`` step): each measure's worst
    error."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.io import weights

    lr, rows = float(gold["lr"]), []
    with no_tf32():
        for t, e in enumerate(gold["eps"]):
            rows.append(step(state, batch, torch.from_numpy(e).to(batch.device), masks=masks))
            if t == 0:
                bn1 = _bn_errors(state.vae.encoder.bns, gold, "_1")
    losses = {k: np.asarray([r[k].item() for r in rows]) for k in rows[0]}
    got_p, _ = weights.vae_to_params(state.vae)
    worst, worst_bias = 0.0, 0.0
    for key in gold.files:
        if key.startswith("delta/"):
            name = key[len("delta/"):]
            delta = (_leaf(got_p, name) - _leaf(params, name)).ravel()[gold[f"index/{name}"]]
            err = float(np.abs(delta - gold[key]).max()) / lr
            if name in ENC_CONV_BIASES:
                worst_bias = max(worst_bias, err)
            else:
                worst = max(worst, err)
    mean_err, var_rel = _bn_errors(state.vae.encoder.bns, gold)
    return {"total_loss": losses["total_loss"],
            "kld_steps": [float(v) for v in np.abs(losses["kld"] / gold["kld"] - 1)],
            "loss_rel": {k: float(np.max(np.abs(losses[k] / gold[k] - 1))) for k in losses},
            "bn1_mean": bn1[0], "bn1_var": bn1[1], "params": worst, "biases": worst_bias,
            "bn_mean": mean_err, "bn_var": var_rel}


def phase_train_golden(dev, critic):
    """23: 3 float32 train steps at full width (TF32 off) from
    numpy_vae_params(0) on the golden's 16 frames with its draws, against
    tests/golden/torch_train_golden.npz, repeated from fresh states, with
    step 1's kld error split into the encoder's and the KL's own; then a step
    on a batch with a NaN frame: parameters, Adam's state and BN stats
    unchanged, counters moved."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.train.step import init_train_state, make_train_step

    gold = np.load(TRAIN_GOLDEN)
    lr, steps = float(gold["lr"]), int(gold["steps"])
    params, bn_state = weights.numpy_vae_params(int(gold["seed"]))
    frames = generate_frames(int(gold["batch"]), seed=int(gold["seed"]))[0]
    batch = torch.from_numpy(frames).to(dev)
    step = make_train_step(critic, learning_rate=lr)
    state = init_train_state(params, bn_state, device=dev)
    kl = _kl_split(state.vae, batch.float().div(255.0).permute(0, 3, 1, 2).contiguous(), gold)
    log(f"[23 train golden] step 1's kld split: the train-mode encoder's mu within "
        f"{kl['mu_abs']:.3e}, logvar within {kl['logvar_abs']:.3e} of JAX's; the KL in float64 "
        f"of the card's mu/logvar {kl['kl64_card_vs_jax']:.3e} relative of JAX's float64; the "
        f"KL's own float32 rounding {kl['kl_f32_vs_f64']:.3e} on the card, "
        f"{kl['kl_jax_f32_vs_f64']:.3e} in JAX")
    runs = []
    for r in range(TRAIN_GOLDEN_RUNS):
        if r:
            state = init_train_state(params, bn_state, device=dev)
        runs.append(_golden_run(state, step, batch, gold, params))
        g = runs[-1]
        log(f"[23 train golden] run {r + 1}/{TRAIN_GOLDEN_RUNS}: {steps} f32 steps, batch "
            f"{int(gold['batch'])}, full width, TF32 off: losses "
            f"{[round(float(v), 7) for v in g['total_loss']]} vs JAX "
            f"{[round(float(v), 7) for v in gold['total_loss']]}; worst relative errors "
            + ", ".join(f"{k} {v:.3e} (bar {TRAIN_LOSS_REL[k]:g})" for k, v in g["loss_rel"].items())
            + f" (kld by step {', '.join(f'{v:.2e}' for v in g['kld_steps'])})"
            + f"; step 1's BN means within {g['bn1_mean']:.3e}, variances {g['bn1_var']:.3e} "
            f"relative (bar {TRAIN_BN1:g}); parameter changes within {g['params']:.4f} lr "
            f"(bar 0.25), encoder conv biases {g['biases']:.3f} lr (bar {2 * steps}); BN means "
            f"within {g['bn_mean']:.3e} (bar {1.5 * lr:.1e}), variances {g['bn_var']:.3e} "
            f"relative (bar {TRAIN_BN_VAR_REL:g})")
    for g in runs:
        require(all(v <= TRAIN_LOSS_REL[k] for k, v in g["loss_rel"].items()),
                f"train golden: loss relative errors {g['loss_rel']}")
        require(g["params"] <= 0.25 and g["biases"] <= 2 * steps,
                "train golden: parameters differ")
        require(g["bn1_mean"] <= TRAIN_BN1 and g["bn1_var"] <= TRAIN_BN1,
                "train golden: step 1's BN stats differ")
        require(g["bn_mean"] <= 1.5 * lr and g["bn_var"] <= TRAIN_BN_VAR_REL,
                "train golden: BN stats differ")
    # a NaN frame: the guard skips the update on the card, with no host sync
    bad = batch.float() / 255.0
    bad[3, 10, 10, 1] = float("nan")
    tensors = (state.params + state.mu + state.nu + state.counts
               + [b for bn in state.vae.encoder.bns for b in (bn.running_mean, bn.running_var)])
    before = [t.detach().clone() for t in tensors]
    with no_tf32():
        loss = step(state, bad)["total_loss"].item()
    unchanged = all(torch.equal(a, b) for a, b in zip(before, tensors))
    counters = (int(state.notfinite_count), bool(state.last_finite),
                int(state.total_notfinite), int(state.step))
    log(f"[23 train golden] a batch with a NaN frame: loss {loss}; parameters, Adam state and "
        f"BN stats unchanged {unchanged}; (notfinite_count, last_finite, total_notfinite, "
        f"step) {counters}")
    require(unchanged and counters == (1, False, 1, steps + 1), "the non-finite guard failed")


def train_step_flops(batch: int) -> dict:
    """Operations of one train step at full width, counted from the shapes:
    the forward's convs and matmuls (the encoder's 5x5 convs, the decoder's
    linear, first conv and 4 phase-split upsample convs of 9 taps an output,
    the critic), 3 times that for forward and backward of the VAE, and the
    MS-SSIM windows (2 separable 11-tap passes of 5 maps a scale) 3 times."""
    dims, c = (32, 64, 128, 256), 3
    enc = sum(2 * (64 >> i) ** 2 * cin * cout * 25
              for i, (cin, cout) in enumerate(zip((c,) + dims[:-1], dims)))
    enc += 2 * 2 * 4096 * 32
    dec = 2 * 33 * 4096 + 2 * 16 * 256 * 128 * 25
    for side, (cin, cout) in zip((8, 16, 32, 64), ((128, 64), (64, 32), (32, 32), (32, 3))):
        dec += 2 * side * side * cin * cout * 9
    critic = (2 * 64 * 64 * 3 * 8 * 9 + 2 * 32 * 32 * 8 * 8 * 9 + 2 * 16 * 16 * 8 * 8 * 9
              + 2 * 8 * 8 * 8 * 16 * 9 + 2 * 16 * 16 * 32 + 2 * 32 * 32 + 2 * 32)
    msssim = sum(5 * 2 * 11 * 2 * (64 >> s) ** 2 * c for s in range(5))
    per_frame = 3 * (enc + dec) + critic + 3 * msssim
    return {"forward_gflop_per_frame": (enc + dec) / 1e9, "step_flops": per_frame * batch}


def phase_train_throughput(dev, critic):
    """24: the multi-step loop at full width, batch 128, on a device-resident
    uint8 dataset: frames/s over 200 steps after warm-up in float32 (TF32 off)
    and bfloat16, timed as 4 windows of 50 steps (median and spread), peak
    memory, the loss over the run, a torch.profiler kernel list with the
    device's idle share, and the share of the operations bound."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.train.step import init_train_state, make_multi_step

    data = torch.from_numpy(generate_frames(TRAIN_FRAMES, seed=3)[0]).to(dev)
    rng = np.random.default_rng(0)
    flops = train_step_flops(TRAIN_BATCH)
    runs = {}
    for dtype, peak in (("float32", F32_FLOPS), ("bfloat16", BF16_FLOPS)):
        state = init_train_state(*weights.numpy_vae_params(0), device=dev)
        multi = make_multi_step(critic, compute_dtype=dtype)
        t = _train_windows(dev, lambda idx: multi(state, data, idx)["total_loss"], rng,
                           TRAIN_FRAMES, TRAIN_STEPS, TRAIN_CHUNK)
        runs[dtype] = t
        window_ms, losses, step_ms = t["window_ms"], t["losses"], t["step_ms"]
        events, kernel_ms, wall = t["events"], t["kernel_ms"], t["wall"]
        per_step, peak_mem, idle, idle_timed = (t["per_step"], t["peak_mem"], t["idle"],
                                                t["idle_timed"])
        bound_ms = 1e3 * flops["step_flops"] / peak
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        rate = 1e3 * TRAIN_BATCH / step_ms
        log(f"[24 train {dtype}] batch {TRAIN_BATCH}, {len(window_ms)} windows of "
            f"{TRAIN_CHUNK} steps: ms a step {[round(v, 3) for v in window_ms]}, median "
            f"{step_ms:.3f} (spread {min(window_ms):.3f}-{max(window_ms):.3f}, "
            f"{max(window_ms) / min(window_ms) - 1:.1%}), {rate:.1f} frames/s at the median; "
            f"peak memory {peak_mem / 2**30:.3f} GiB; loss {first:.5f} (first 20) -> "
            f"{last:.5f} (last 20); bound {bound_ms:.3f} ms a step "
            f"({flops['step_flops'] / 1e9:.1f} GFLOP at {peak / 1e12:g} TFLOP/s; forward "
            f"{flops['forward_gflop_per_frame']:.3f} GFLOP a frame), {bound_ms / step_ms:.1%} of "
            f"it reached")
        log(f"[24 train {dtype}] profile of 10 more steps: {kernel_ms / 10:.3f} ms of kernels a "
            f"step in {1e2 * wall:.3f} ms of wall a step under the profiler, device idle "
            f"{idle:.1%} (against the timed median's {step_ms:.3f} ms: {idle_timed:.1%}); "
            f"{per_step:.0f} kernel launches a step")
        for e in events[:8]:
            log(f"[24 train {dtype}]   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
                f"{e.key[:100]}")
        require(np.isfinite(losses).all() and last < first,
                f"train {dtype}: the loss did not fall ({first} -> {last})")
        require(all(p.dtype == torch.float32 for p in state.params + state.mu + state.nu),
                f"train {dtype}: the state left float32")
        del state, multi
    return runs


def _train_windows(dev, run, rng, frames: int, steps: int, chunk: int, batch: int = TRAIN_BATCH,
                   warmup: int = 10, profiled: int = 10) -> dict:
    """Time ``run(idx) -> (K,) losses`` (K training steps on the batches of
    a (K, batch) index tensor of rows drawn from ``rng`` out of ``frames``)
    after a warm-up of ``warmup`` steps, as ``steps // chunk`` windows of
    ``chunk`` steps: ms a step per window and their median, the losses, peak
    memory, and a torch.profiler run of ``profiled`` more steps (kernel time,
    launches a step, the device's idle share against that run's wall and
    against the timed median)."""
    import numpy as np
    import torch

    def idx(k):
        rows = [rng.permutation(frames)[:batch] for _ in range(k)]
        return torch.from_numpy(np.stack(rows).astype(np.int32)).to(dev)

    with no_tf32():
        run(idx(warmup))  # cuDNN's algorithm choices
        windows = [idx(chunk) for _ in range(steps // chunk)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, window_ms = [], []
        for w in windows:
            t0 = time.perf_counter()
            losses.append(run(w))
            torch.cuda.synchronize()
            window_ms.append(1e3 * (time.perf_counter() - t0) / chunk)
        peak_mem = torch.cuda.max_memory_allocated(dev)
        losses = torch.cat(losses).cpu().numpy()
        prof_idx = idx(profiled)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            run(prof_idx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
    events = _device_ops(prof)
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    step_ms = float(np.median(window_ms))
    return {"window_ms": window_ms, "step_ms": step_ms, "losses": losses, "peak_mem": peak_mem,
            "events": events, "kernel_ms": kernel_ms, "wall": wall,
            "per_step": sum(e.count for e in events) / profiled,
            "idle": max(0.0, 1.0 - kernel_ms / (1e3 * wall)),
            # the profiler slows the host: against the timed steps' wall too
            "idle_timed": max(0.0, 1.0 - kernel_ms / profiled / step_ms)}


def _cli(args):
    """``python -m critic_vae_tpu_torch ARGS`` in this process (the same
    entry point, without a second process's start): (exit code, stdout lines)."""
    import io

    from critic_vae_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args)
    return rc, [ln for ln in buf.getvalue().replace("\r", "\n").splitlines() if ln.strip()]


def phase_train_commands(dev, critic, scratch: Path):
    """25: ``train --source synthetic:2:256 --epochs 1 --batch-size 128``
    twice (the second resumes and takes no step); with Pillow,
    :func:`_eval_commands`; then ``evaluate_images`` over 1024 + 16 frames
    with the launch counts set to 0 just before and read just after, the 16
    golden frames' maps and preds at the bars against the golden's, and B1
    against its plain version at the shapes eval gives it."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.io import checkpoint as ckpt_io
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.ops.diff_mask import diff_mask, diff_mask_reference
    from critic_vae_tpu_torch.ops.mask import decode_pair
    from critic_vae_tpu_torch.pipelines.evaluate import evaluate_images

    root = scratch / "root_train"
    root.mkdir()
    train_args = ["train", "--source", "synthetic:2:256", "--epochs", "1", "--batch-size",
                  str(TRAIN_BATCH), "--root", str(root), "--log-dir", str(root / "logs"),
                  "--device", dev.type]
    t0 = time.perf_counter()
    rc, lines = _cli(train_args)
    secs = time.perf_counter() - t0
    first = ckpt_io.latest_checkpoint(str(root / "checkpoints"))
    log(f"[25 commands] train: exit {rc} in {secs:.1f} s; " + " | ".join(lines)
        + f"; checkpoint {first}")
    require(rc == 0 and first is not None and first[1] > 0, "train failed")
    require((root / "saved-networks" / "vae_encoder.ckpt").is_file(), "train saved no encoder")
    rc, lines = _cli(train_args)
    again = ckpt_io.latest_checkpoint(str(root / "checkpoints"))
    log(f"[25 commands] train again: exit {rc}; " + " | ".join(lines))
    require(rc == 0 and any(ln.startswith("resumed from") for ln in lines)
            and again[1] == first[1], "the second train did not resume without a step")
    weights.load_final_weights(str(root / "saved-networks" / "vae_encoder.ckpt"),
                               str(root / "saved-networks" / "vae_decoder.ckpt"))

    gold = np.load(ROOT / "tests" / "golden" / "torch_slice_golden.npz")
    n = int(gold["num_frames"])
    frames = generate_frames(n, seed=int(gold["seed"]))[0]
    params, state = weights.numpy_vae_params(int(gold["seed"]))
    try:
        import PIL  # noqa: F401  (the commands read and write PNGs)
    except ImportError:
        log("[25 commands] Pillow is not installed: eval, inject and evalsecond are not run "
            "(they read PNGs); evaluate_images runs below")
    else:
        _eval_commands(dev, scratch, frames, params, state, gold)

    # the main path in-process: B1 launched at the eval batch, held against its plain version
    vae = weights.vae_from_params(params, state).to(dev)
    many = generate_frames(EVAL_FRAMES, seed=5)[0].astype(np.float32) / 255.0
    stills = frames.astype(np.float32) / 255.0
    evaluate_images(vae, critic, stills, device=dev)  # warm-up
    res, launches = _drive("eval", lambda: (evaluate_images(vae, critic, many, device=dev),
                                            evaluate_images(vae, critic, stills, device=dev)),
                           ("diff_mask",), EVAL_FRAMES + n, phase="25 commands")
    require(launches["diff_mask"] == EVAL_FRAMES // MAIN_BATCH + 1, f"eval launches {launches}")
    require(all(r["diff_u8"].shape == (len(x), H, W) and np.isfinite(r["preds"]).all()
                for r, x in zip(res, (many, stills))), "eval results malformed")
    within = float(np.mean(np.abs(res[1]["diff_u8"].astype(int) - gold["diff_u8"].astype(int))
                           <= 1))
    pred_err = float(np.abs(res[1]["preds"] - gold["preds"]).max())
    log(f"[25 commands] evaluate_images on the golden's {n} frames: maps within one level of "
        f"the JAX package's {within:.6f} (bar 0.999), preds max_abs_err {pred_err:.3e} "
        f"(bar 1e-4)")
    require(within >= 0.999 and pred_err <= 1e-4, "evaluate_images against the golden")
    err = 0.0
    with torch.inference_mode(), no_tf32():
        for x in (many[:MAIN_BATCH], stills):
            xt = torch.from_numpy(x).to(dev).permute(0, 3, 1, 2).contiguous()
            pre = decode_pair(vae, xt, critic(xt)[:, 0])
            (gk, mk), (gr, mr) = diff_mask(pre), diff_mask_reference(pre)
            err = max(err, (gk - gr).abs().max().item(), (mk - mr).abs().max().item())
    log(f"[25 commands] B1 at eval's f32 decodes (2 x {MAIN_BATCH}, 3, 64, 64) and "
        f"(2 x {n}, 3, 64, 64): max_abs_err {err:.3e} against its plain version (bar 1e-6)")
    require(err <= 1e-6, f"B1 at eval's shapes: {err}")
    return launches, err


def _eval_commands(dev, scratch: Path, frames, params, state, gold):
    """``eval``, ``inject --values 0,0.5,1`` and ``evalsecond`` on PNGs of
    the golden's frames with ``numpy_vae_params`` artifacts: exit 0, a strip
    a frame, eval's and evalsecond's maps (the strips' 4th panel) >= 99.9%
    within one level of the golden's."""
    import numpy as np
    from PIL import Image

    from critic_vae_tpu_torch.io import checkpoint as ckpt_io

    n = len(frames)
    eroot = scratch / "root_eval"
    (eroot / "source-images").mkdir(parents=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(eroot / "source-images" / f"frame-{i:02d}.png")
    for enc, dec in (("saved-networks/vae_encoder.ckpt", "saved-networks/vae_decoder.ckpt"),
                     ("vae2_encoder.ckpt", "vae2_decoder.ckpt")):
        ckpt_io.save_pytree(str(eroot / enc), {"params": params["encoder"], "bn_state": state})
        ckpt_io.save_pytree(str(eroot / dec), {"params": params["decoder"]})
    common = ["--root", str(eroot), "--device", dev.type]
    for command, extra, out in (("eval", [], "images"), ("inject", ["--values", "0,0.5,1"],
                                                         "inject"),
                                ("evalsecond", ["--out", str(eroot / "second")], "second")):
        rc, lines = _cli([command, *common, *extra])
        log(f"[25 commands] {command}: exit {rc}; " + " | ".join(lines))
        require(rc == 0 and len(list((eroot / out).glob("image-*.png"))) == n,
                f"{command} failed")
        if command != "inject":
            maps = np.stack([np.asarray(Image.open(eroot / out / f"image-{i:03d}.png"))
                             [:, 3 * W:4 * W, 0] for i in range(n)])
            within = float(np.mean(np.abs(maps.astype(int) - gold["diff_u8"].astype(int)) <= 1))
            equal = float(np.mean(maps == gold["diff_u8"]))
            log(f"[25 commands] {command}'s maps against the JAX package's (golden): within one "
                f"level {within:.6f} (bar 0.999), equal {equal:.6f}")
            require(within >= 0.999, f"{command}: maps within one level {within}")
    require(Image.open(eroot / "inject" / "image-000.png").size == (4 * W, H), "inject strips")


DISTILL_GOLDEN = ROOT / "tests" / "golden" / "torch_distill_golden.npz"
CRITIC_GOLDEN = ROOT / "tests" / "golden" / "torch_critic_golden.npz"
DISTILL_FRAMES = 8192        # phase 26's main path: 128 B2 launches at chunk 64
DISTILL_TRAIN_FRAMES = 2048  # phase 26's multi-step dataset (its first frames and masks)
DISTILL_LOSS_REL = {**TRAIN_LOSS_REL, "md_loss": 1e-5}
CRITIC_TRAIN_FRAMES = 12800  # traincritic's default --synthetic-frames: 100 steps an epoch
CRITIC_WINDOW = 25           # phase 27: 4 windows of 25 steps, one epoch
CRITIC_LOSS_REL = 1e-5       # phase 27's bars: the CPU tests' (tests/test_torch_critic_train.py)
HEALTH_TOL = 1e-3
RECON_FRAMES_SOURCE = "synthetic:8:1024"  # phase 28's build_recon_dataset rate


def _bits(gold, key):
    import numpy as np

    return np.unpackbits(gold[key], axis=-1, count=W).astype(bool)


def phase_distill(dev, critic, smi: str, scratch: Path, baseline=None):
    """26: pseudo-label masks and mask-distillation training (module doc);
    ``baseline``: phase 24's float32 timing, printed beside the term's."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.crf.device import refine_masks_device
    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines.distill import CAM_TUNED_CRF_PARAMS, build_pseudo_masks
    from critic_vae_tpu_torch.train.critic import critic_cam_health
    from critic_vae_tpu_torch.train.step import (init_train_state, make_multi_step,
                                                 make_train_step)

    gold = np.load(DISTILL_GOLDEN)
    n = int(gold["num_frames"])
    frames = generate_frames(n, seed=int(gold["frames_seed"]))[0]
    thr = build_pseudo_masks(critic, frames, run_crf=False, device=dev)
    crf = build_pseudo_masks(critic, frames, device=dev)
    a_thr = float(np.mean(thr == _bits(gold, "thr_bits")))
    a_crf = float(np.mean(crf == _bits(gold, "crf_bits")))
    log(f"[26 distill] golden ({n} frames, the JAX package's float32 masks on the CPU): "
        f"LayerCAM threshold masks identical {a_thr:.6f} (bar 0.998); CRF masks through B2 "
        f"(bf16) identical to its float32 xla build's {a_crf:.6f} (bar 0.999)")
    require(a_thr >= 0.998 and a_crf >= 0.999, "distill golden masks")

    many = generate_frames(DISTILL_FRAMES, seed=26)[0]
    build_pseudo_masks(critic, many[:MAIN_BATCH], device=dev)  # warm-up
    masks, launches = _drive("build_pseudo_masks", lambda: build_pseudo_masks(
        critic, many, device=dev), ("bilateral_build",), DISTILL_FRAMES, phase="26 distill")
    require(launches["bilateral_build"] == DISTILL_FRAMES // CRF_CHUNK,
            f"B2 launches {launches['bilateral_build']}, not one a {CRF_CHUNK}-frame chunk")
    require(launches["diff_mask"] == 0, "build_pseudo_masks launched B1")
    require(masks.shape == (DISTILL_FRAMES, H, W) and masks.dtype == bool and masks.any(),
            "pseudo masks malformed")
    t0 = time.perf_counter()
    thr_many = build_pseudo_masks(critic, many, run_crf=False, device=dev)
    thr_s = time.perf_counter() - t0
    crf_s, refined = timed(lambda: refine_masks_device(
        many, thr_many, CAM_TUNED_CRF_PARAMS, device=dev), 1, warmup=0)
    crf_s /= 1e3
    health = critic_cam_health(critic, many, device=dev)
    agree = float(np.mean(refined == masks))
    log(f"[26 distill] {smi}: build_pseudo_masks without the CRF {DISTILL_FRAMES / thr_s:.1f} "
        f"frames/s ({thr_s:.3f} s); its CRF part alone (refine_masks_device, B2 bf16, CAM-tuned "
        f"parameters) {DISTILL_FRAMES / crf_s:.1f} frames/s ({crf_s:.3f} s), masks identical to "
        f"the path's {agree:.6f}; mask pixels {masks.mean():.4f} of all; CAM health (first 512 "
        f"frames) " + " ".join(f"{k}={v:.4g}" for k, v in health.items()))

    # 3 float32 steps with the term against the golden, at phase 23's bars, on
    # its step rows (frames the critic scores >= 0.05: make_torch_slice_golden.py
    # says why)
    rows, md = gold["step_rows"], float(gold["mask_distill"])
    batch_n = len(rows)
    params, bn_state = weights.numpy_vae_params(int(gold["seed"]))
    batch = torch.from_numpy(frames[rows]).to(dev)
    gmasks = torch.from_numpy(_bits(gold, "crf_bits")[rows]).to(dev)
    lr, steps = float(gold["lr"]), int(gold["steps"])
    step = make_train_step(critic, learning_rate=lr, mask_distill=md)
    # cuDNN's default float32 backward is nondeterministic, and the term
    # turns the parameters' run-to-run drift into step 3's loss errors (3
    # runs: total 1.0e-05-1.24e-05, md 2.7e-05-3.5e-05, kld up to 1.04e-04);
    # its deterministic algorithms give one answer a card
    with _deterministic():
        g = _golden_run(init_train_state(params, bn_state, device=dev), step, batch, gold,
                        params, masks=gmasks)
    log(f"[26 distill] golden steps: {steps} f32 steps with mask_distill={md}, batch {batch_n}, "
        f"full width, cuDNN's deterministic algorithms: worst relative errors "
        + ", ".join(f"{k} {v:.3e} (bar {DISTILL_LOSS_REL[k]:g})" for k, v in g["loss_rel"].items())
        + f"; parameter changes within {g['params']:.4f} lr (bar 0.25), encoder conv biases "
        f"{g['biases']:.3f} lr (bar {2 * steps}); BN means within {g['bn_mean']:.3e} (bar "
        f"{1.5 * lr:.1e}), variances {g['bn_var']:.3e} relative (bar {TRAIN_BN_VAR_REL:g})")
    require(set(g["loss_rel"]) == set(DISTILL_LOSS_REL)
            and all(v <= DISTILL_LOSS_REL[k] for k, v in g["loss_rel"].items()),
            f"distill golden: loss relative errors {g['loss_rel']}")
    require(g["params"] <= 0.25 and g["biases"] <= 2 * steps, "distill golden: parameters")
    require(g["bn_mean"] <= 1.5 * lr and g["bn_var"] <= TRAIN_BN_VAR_REL, "distill golden: BN")

    # the multi-step loop with the term, timed as phase 24's float32 run
    data = torch.from_numpy(many[:DISTILL_TRAIN_FRAMES]).to(dev)
    mask_rows = torch.from_numpy(masks[:DISTILL_TRAIN_FRAMES].astype(np.uint8)).to(dev)
    state = init_train_state(*weights.numpy_vae_params(0), device=dev)
    multi = make_multi_step(critic, mask_distill=0.5)
    t = _train_windows(dev, lambda idx: multi(state, data, idx, masks=mask_rows)["total_loss"],
                       np.random.default_rng(0), DISTILL_TRAIN_FRAMES, TRAIN_STEPS, TRAIN_CHUNK)
    first, last = float(t["losses"][:20].mean()), float(t["losses"][-20:].mean())
    log(f"[26 distill] {smi}: the multi-step loop with mask_distill=0.5, float32, batch "
        f"{TRAIN_BATCH}, {len(t['window_ms'])} windows of {TRAIN_CHUNK} steps: ms a step "
        f"{[round(v, 3) for v in t['window_ms']]}, median {t['step_ms']:.3f} (spread "
        f"{max(t['window_ms']) / min(t['window_ms']) - 1:.1%}), "
        f"{1e3 * TRAIN_BATCH / t['step_ms']:.1f} frames/s; device idle {t['idle']:.1%} under "
        f"the profiler ({t['idle_timed']:.1%} against the median); {t['per_step']:.0f} kernel "
        f"launches a step; loss {first:.5f} -> {last:.5f}")
    if baseline is not None:
        log(f"[26 distill] beside phase 24's float32 run without the term: median "
            f"{baseline['step_ms']:.3f} ms a step ({t['step_ms'] / baseline['step_ms']:.2f}x "
            f"with it), device idle {baseline['idle']:.1%} ({baseline['idle_timed']:.1%} "
            f"against its median), {baseline['per_step']:.0f} kernel launches a step")
    require(np.isfinite(t["losses"]).all() and last < first, "distill: the loss did not fall")
    del state, multi, data, mask_rows

    root = scratch / "root_distill"
    root.mkdir()
    args = ["train", "--source", "synthetic:2:256", "--epochs", "1", "--mask-distill", "0.3",
            "--root", str(root), "--log-dir", str(root / "logs"), "--device", dev.type]
    t0 = time.perf_counter()
    rc, lines = _cli(args)
    log(f"[26 distill] train --mask-distill 0.3: exit {rc} in {time.perf_counter() - t0:.1f} s; "
        + " | ".join(lines))
    require(rc == 0 and any(ln.startswith("building pseudo-label masks") for ln in lines)
            and (root / "saved-networks" / "vae_decoder.ckpt").is_file(),
            "train --mask-distill failed")
    return launches, t


def _critic_masks(gold, t):
    """Step ``t``'s dropout keep masks of the critic golden, NCHW."""
    import numpy as np
    import torch

    out = []
    for j, shape in enumerate(((8, 8, 8), (4, 4, 16), (32,))):
        m = np.unpackbits(gold[f"mask{t}_{j}"], axis=-1, count=shape[-1]).astype(bool)
        out.append(torch.from_numpy(m.transpose(0, 3, 1, 2).copy() if m.ndim == 4 else m))
    return out


def phase_critic_train(dev, smi: str, scratch: Path):
    """27: critic training (module doc)."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.train import critic as tc

    gold = np.load(CRITIC_GOLDEN)
    n, lr = int(gold["num_frames"]), float(gold["lr"])
    frames = generate_frames(n, seed=int(gold["frames_seed"]))[0]
    state = tc.init_critic_state(weights.numpy_critic_params(0), device=dev)
    step = tc.make_critic_step(learning_rate=lr, dropout_rate=float(gold["dropout"]))
    batch = torch.from_numpy(frames).to(dev)
    labels = torch.from_numpy(gold["labels"]).to(dev)
    with no_tf32():
        losses = [step(state, batch, labels, [m.to(dev) for m in _critic_masks(gold, t)]).item()
                  for t in range(int(gold["steps"]))]
    loss_rel = float(np.max(np.abs(np.asarray(losses) / gold["losses"] - 1)))
    got = weights.critic_to_params(state.critic)
    param_err = max(float(np.abs(got[k] - gold[f"params/{k}"]).max()) for k in got) / lr
    log(f"[27 critic] golden: {int(gold['steps'])} critic steps, batch {n}, dropout "
        f"{float(gold['dropout']):g}, JAX's masks: losses {[round(v, 7) for v in losses]} vs JAX "
        f"{[round(float(v), 7) for v in gold['losses']]}, worst relative error {loss_rel:.3e} "
        f"(bar {CRITIC_LOSS_REL:g}); parameters within {param_err:.4f} lr (bar 0.25)")
    require(loss_rel <= CRITIC_LOSS_REL and param_err <= 0.25, "critic golden")

    frames, gt = generate_frames(CRITIC_TRAIN_FRAMES, seed=27)
    soft = tc.soft_trunk_labels(gt)
    t0 = time.perf_counter()
    params, loss = tc.train_critic(frames, soft, epochs=1, batch_size=TRAIN_BATCH, device=dev,
                                   progress=False)
    secs = time.perf_counter() - t0
    log(f"[27 critic] {smi}: train_critic, 1 epoch of {CRITIC_TRAIN_FRAMES // TRAIN_BATCH} steps "
        f"at batch {TRAIN_BATCH} on {CRITIC_TRAIN_FRAMES} frames: {secs:.3f} s "
        f"({CRITIC_TRAIN_FRAMES / secs:.1f} frames/s, first epoch), loss {loss:.4f}")
    state = tc.init_critic_state(weights.numpy_critic_params(0), device=dev, seed=1)
    multi = tc.make_critic_multi_step()
    data = torch.from_numpy(frames).to(dev)
    lab = torch.from_numpy(soft).to(dev)
    steps = CRITIC_TRAIN_FRAMES // TRAIN_BATCH
    t = _train_windows(dev, lambda idx: multi(state, data, lab, idx), np.random.default_rng(1),
                       CRITIC_TRAIN_FRAMES, steps, CRITIC_WINDOW, warmup=5)
    first = float(t["losses"][:CRITIC_WINDOW].mean())
    last = float(t["losses"][-CRITIC_WINDOW:].mean())
    log(f"[27 critic] {smi}: the critic's multi-step loop, batch {TRAIN_BATCH}, "
        f"{len(t['window_ms'])} windows of {CRITIC_WINDOW} steps (one epoch): ms a step "
        f"{[round(v, 4) for v in t['window_ms']]}, median {t['step_ms']:.4f} (spread "
        f"{max(t['window_ms']) / min(t['window_ms']) - 1:.1%}), "
        f"{1e3 * TRAIN_BATCH / t['step_ms']:.1f} frames/s; {t['kernel_ms'] / 10:.4f} ms of "
        f"kernels a step, device idle {t['idle']:.1%} under the profiler "
        f"({t['idle_timed']:.1%} against the median), {t['per_step']:.0f} kernel launches a "
        f"step; loss {first:.5f} (first window) -> {last:.5f} (last)")
    require(np.isfinite(t["losses"]).all() and last < first, "critic: the loss did not fall")

    synthetic = weights.critic_from_params(weights.load_critic(
        str(ROOT / "saved-networks" / "critic-synthetic.npz")))
    health = tc.critic_cam_health(synthetic, generate_frames(
        int(gold["health_frames"]), seed=int(gold["health_seed"]))[0], device=dev)
    worst = max(abs(health[k] - float(gold[f"health/{k}"])) for k in health)
    log(f"[27 critic] critic_cam_health of the synthetic critic on the golden's frames: "
        + " ".join(f"{k}={v:.6g}" for k, v in health.items())
        + f"; worst field off JAX's by {worst:.3e} (bar {HEALTH_TOL:g})")
    require(worst <= HEALTH_TOL, "critic_cam_health against the golden")

    out = scratch / "critic.npz"
    t0 = time.perf_counter()
    rc, lines = _cli(["traincritic", "--synthetic-frames", "1024", "--epochs", "2",
                      "--cam-select", "2", "--out", str(out), "--root", str(scratch),
                      "--device", dev.type])
    log(f"[27 critic] traincritic --synthetic-frames 1024 --epochs 2 --cam-select 2: exit {rc} "
        f"in {time.perf_counter() - t0:.1f} s; " + " | ".join(lines))
    require(rc == 0 and out.is_file(), "traincritic failed")
    reloaded = weights.critic_from_params(weights.load_critic(str(out))).to(dev)
    with torch.inference_mode():
        p = reloaded(torch.rand(4, 3, H, W, device=dev))
    require(p.shape == (4, 1) and bool(torch.isfinite(p).all()), "the saved critic")
    return t


def phase_data_export(dev, critic, smi: str, scratch: Path):
    """28: the recon dataset, the second VAE and export (module doc)."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.sources import open_source
    from critic_vae_tpu_torch.io import checkpoint as ckpt_io
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines.dataset import build_recon_dataset

    root = scratch / "root_data"
    (root / "saved-networks").mkdir(parents=True)
    params, state = weights.numpy_vae_params(0)
    ckpt_io.save_pytree(str(root / "saved-networks" / "vae_encoder.ckpt"),
                        {"params": params["encoder"], "bn_state": state})
    ckpt_io.save_pytree(str(root / "saved-networks" / "vae_decoder.ckpt"),
                        {"params": params["decoder"]})
    common = ["--root", str(root), "--device", dev.type]
    commands = [["dataset", "--source", "synthetic:2:256"], ["second", "--epochs", "1"]]
    try:
        from PIL import Image
    except ImportError:
        Image = None
        log("[28 data] Pillow is not installed: evalsecond is not run (it reads PNGs)")
    else:
        from critic_vae_tpu_torch.data.synthetic import generate_frames

        (root / "source-images").mkdir()
        for i, f in enumerate(generate_frames(4, seed=28)[0]):
            Image.fromarray(f).save(root / "source-images" / f"frame-{i}.png")
        commands.append(["evalsecond"])
    for command in commands:
        t0 = time.perf_counter()
        rc, lines = _cli([*command, *common])
        log(f"[28 data] {' '.join(command)}: exit {rc} in {time.perf_counter() - t0:.1f} s; "
            + " | ".join(lines))
        require(rc == 0, f"{command[0]} failed")
    require((root / "vae2_encoder.ckpt").is_file(), "second wrote no encoder")
    require(Image is None or len(list((root / "images").glob("image-*.png"))) == 4,
            "evalsecond wrote no strips")

    vae = weights.vae_from_params(params, state).to(dev)
    build_recon_dataset(open_source("synthetic:1:512"), critic, vae, device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dset = build_recon_dataset(open_source(RECON_FRAMES_SOURCE), critic, vae, device=dev)
    secs = time.perf_counter() - t0
    log(f"[28 data] {smi}: build_recon_dataset over {RECON_FRAMES_SOURCE} (trajectories made "
        f"on the host inside the timing): {len(dset)} recon frames in {secs:.3f} s, "
        f"{len(dset) / secs:.1f} frames/s")
    require(dset.shape[1:] == (H, W, 3) and np.isfinite(dset).all(), "recon dataset malformed")

    paths = {k: str(scratch / f"export_{k}.pt") for k in ("enc", "dec", "critic")}
    rc, lines = _cli(["export", "--encoder-out", paths["enc"], "--decoder-out", paths["dec"],
                      "--critic-out", paths["critic"], *common])
    log(f"[28 data] export: exit {rc}; " + " | ".join(lines))
    require(rc == 0, "export failed")
    enc_sd, dec_sd = weights.vae_state_dicts_to_torch(params, state)
    crit_sd = weights.critic_state_dict_to_torch(weights.load_critic(
        str(ROOT / "saved-networks" / "critic-synthetic.npz")))
    for key, want in (("enc", enc_sd), ("dec", dec_sd), ("critic", crit_sd)):
        got = torch.load(paths[key], weights_only=True)
        require(list(got) == list(want) and all(
            got[k].numpy().dtype == v.dtype and got[k].numpy().shape == v.shape
            and np.array_equal(got[k].numpy(), v) for k, v in want.items()),
            f"export {key}: not bitwise the source")
    film = scratch / "root_film"
    (film / "saved-networks").mkdir(parents=True)
    fparams, fstate = weights.numpy_vae_params(0, film=True)
    ckpt_io.save_pytree(str(film / "saved-networks" / "vae_encoder.ckpt"),
                        {"params": fparams["encoder"], "bn_state": fstate})
    ckpt_io.save_pytree(str(film / "saved-networks" / "vae_decoder.ckpt"),
                        {"params": fparams["decoder"]})
    proc = subprocess.run(
        [sys.executable, "-m", "critic_vae_tpu_torch", "export", "--root", str(film),
         "--encoder-out", str(film / "e.pt"), "--decoder-out", str(film / "d.pt")],
        capture_output=True, text=True, timeout=300, cwd=scratch,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    last = proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ""
    log(f"[28 data] export of a FiLM decoder: exit {proc.returncode}; {last}")
    require(proc.returncode == 1 and "FiLM" in last and not (film / "e.pt").exists(),
            "the FiLM export was not refused")


def _trace_names(trace_dir: Path):
    """(span and op names, kernel names) of the Chrome traces under
    ``trace_dir`` (utils/profiling.py's files)."""
    names, kernels = set(), set()
    for path in sorted(trace_dir.rglob("*.pt.trace.json")):
        for event in json.loads(path.read_text()).get("traceEvents", []):
            name = event.get("name")
            if not isinstance(name, str):
                continue
            (kernels if event.get("cat") == "kernel" else names).add(name)
    return names, kernels


def _iou_lines(lines):
    return [ln for ln in lines if ln.startswith(("thr_iou=", "crf_iou="))]


def phase_parallel(dev, critic, vae, smi: str, scratch: Path):
    """29: (a) ``video --profile`` on the card, its trace naming B1 and B2;
    (b) ``video --num-devices 1`` under ``torch.distributed.run`` (one rank,
    NCCL) against (d) the unmeshed ``video --root R`` that finds its episode
    and artifacts under R (C.8); (c) ``eval_episode`` with and without a
    one-rank NCCL mesh in this process, 3 reps each, as a main path."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.parallel.distributed import init_distributed
    from critic_vae_tpu_torch.parallel.mesh import make_mesh
    from critic_vae_tpu_torch.pipelines.video import eval_episode

    root = scratch / "root"
    ep = root / "minerl-episode"
    generate_episode(str(ep), num_frames=PARALLEL_FRAMES, seed=29)
    nets = root / "saved-networks"
    nets.mkdir()
    params, state = weights.numpy_vae_params(0)
    enc, dec = nets / "vae_encoder.ckpt", nets / "vae_decoder.ckpt"
    _save_zip_pytree(enc, {"params": params["encoder"], "bn_state": state})
    _save_zip_pytree(dec, {"params": params["decoder"]})
    common = ["--no-slice", "--no-gif", "--dtype", "bfloat16", "--device", dev.type]
    explicit = ["--episode", str(ep), "--encoder", str(enc), "--decoder", str(dec)]

    # (d) C.8: the defaults under --root, unmeshed; the reference of (a) and (b)
    proc, secs = _run_cli(["--root", str(root), *common], scratch)
    lines = proc.stdout.splitlines()
    log(f"[29 parallel d] video --root R (episode and artifacts under R): exit "
        f"{proc.returncode} in {secs:.1f} s; " + " | ".join(lines))
    require(proc.returncode == 0, f"video --root failed: {proc.stderr[-2000:]}")
    want = _iou_lines(lines)
    require(len(want) == 2 and "crf backend: device (auto)" in lines,
            f"video --root: no IoUs or not the device CRF: {lines}")
    bin_info = (root / "bin_info_vae1.txt").read_bytes()

    # (a) --profile: a trace naming B1 and B2, and the same IoUs
    trace = scratch / "trace"
    out_a = scratch / "root_a"
    out_a.mkdir()
    proc, secs = _run_cli([*explicit, "--root", str(out_a), "--profile", str(trace), *common],
                          scratch)
    lines = proc.stdout.splitlines()
    require(proc.returncode == 0, f"video --profile failed: {proc.stderr[-2000:]}")
    names, kernels = _trace_names(trace)
    files = sorted(p.name for p in trace.rglob("*.pt.trace.json"))
    b1_k = sorted(k for k in kernels if "diff_mask" in k)
    b2_k = sorted(k for k in kernels if "tile_store_kernel" in k or "tile_rowsum_kernel" in k)
    log(f"[29 parallel a] video --profile: exit {proc.returncode} in {secs:.1f} s; trace "
        f"{files}: spans diff_mask {'diff_mask' in names}, bilateral_build "
        f"{'bilateral_build' in names}; {len(kernels)} kernel names, B1's {b1_k[:1]}, "
        f"B2's {[k[:60] for k in b2_k]}")
    require(len(files) == 1, f"video --profile: {files} traces")
    require({"diff_mask", "bilateral_build"} <= names and b1_k and b2_k,
            "the --profile trace does not name B1 and B2")
    require(_iou_lines(lines) == want, f"video --profile: IoUs {_iou_lines(lines)} != {want}")

    # (b) one rank on NCCL under the launcher, --num-devices 1
    out_b = scratch / "root_b"
    out_b.mkdir()
    rc, lines, err, secs = _torchrun(["video", *explicit, "--root", str(out_b),
                                      "--num-devices", "1", *common], scratch)
    log(f"[29 parallel b] torch.distributed.run --nproc-per-node 1 video --num-devices 1: exit "
        f"{rc} in {secs:.1f} s; " + " | ".join(lines))
    require(rc == 0, f"torchrun video failed: {err[-3000:]}")
    require(lines[:2] == ["multi-host: 1 processes, 1 devices",
                          "sharding the device stage over 1 device(s)"],
            f"torchrun video: no multi-host/sharding lines: {lines[:3]}")
    same_bin = (out_b / "bin_info_vae1.txt").read_bytes() == bin_info
    log(f"[29 parallel b] IoU lines {_iou_lines(lines)} against the unmeshed {want}; "
        f"bin_info_vae1.txt byte-identical: {same_bin}")
    require(_iou_lines(lines) == want and same_bin, "the one-rank NCCL video differs")

    # (c) eval_episode with and without a one-rank NCCL mesh in this process
    frames, gt = generate_frames(MAIN_FRAMES, seed=0)
    kw = dict(device=dev, batch_size=MAIN_BATCH, compute_dtype="bfloat16", crf_backend="auto",
              threshold=50)
    require(not torch.distributed.is_initialized(), "a process group exists before phase 29")
    init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0, device="cuda")
    try:
        mesh = make_mesh(1, dev)
        require(mesh.group is not None and torch.distributed.get_backend() == "nccl",
                "no NCCL group")
        eval_episode(vae, critic, frames[:MAIN_BATCH], gt[:MAIN_BATCH], mesh=mesh, **kw)
        eval_episode(vae, critic, frames[:MAIN_BATCH], gt[:MAIN_BATCH], **kw)  # warm-ups
        res, launches = _drive("g eval_episode 1-rank NCCL mesh",
                               lambda: eval_episode(vae, critic, frames, gt, mesh=mesh, **kw),
                               ("diff_mask", "bilateral_build"), MAIN_FRAMES,
                               phase="29 parallel")
        plain = eval_episode(vae, critic, frames, gt, **kw)
        same = (np.array_equal(res.preds, plain.preds) and np.array_equal(res.diff_u8, plain.diff_u8)
                and np.array_equal(res.thr_masks, plain.thr_masks)
                and np.array_equal(res.crf_masks, plain.crf_masks))
        rates = {"mesh": [], "plain": []}
        for _ in range(PARALLEL_REPS):
            for key, m in (("mesh", mesh), ("plain", None)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eval_episode(vae, critic, frames, gt, mesh=m, **kw)
                torch.cuda.synchronize()
                rates[key].append(MAIN_FRAMES / (time.perf_counter() - t0))
    finally:
        torch.distributed.destroy_process_group()
    med = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
    log(f"[29 parallel c] eval_episode over {MAIN_FRAMES} frames (bf16, chunk {MAIN_BATCH}, "
        f"device CRF): frames/s with the one-rank NCCL mesh "
        f"{', '.join(f'{r:.1f}' for r in rates['mesh'])} (median {med['mesh']:.1f}), without "
        f"{', '.join(f'{r:.1f}' for r in rates['plain'])} (median {med['plain']:.1f}); "
        f"mesh/plain {med['mesh'] / med['plain']:.4f}; results identical: {same}; {smi}")
    require(same, "the one-rank mesh changed eval_episode's results")
    return launches


PTRAIN_FRAMES = 1024        # phase 30's dataset
PTRAIN_STEPS = 3            # phase 30's parity steps
PTRAIN_WINDOWS = 4          # phase 30's timed windows a variant, alternating
PTRAIN_MESH_REL = 1e-6      # phase 30 (a): losses of the one-rank mesh against none
# host-side ops of the mesh's collectives in a torch.profiler CPU trace
COLLECTIVE_HOST_OPS = ("record_param_comms", "c10d::allreduce_", "_AllSum", "_AllSumBackward")


def _ptrain_inputs():
    """Phase 30's steps: the dataset, the replicated loop's global (3, 128)
    rows, the sharded loop's local offsets over 2 ranks and their global
    equivalents, and the (3, 128, 32) draws, all from seeds."""
    import numpy as np

    from critic_vae_tpu_torch.data.synthetic import generate_frames
    from critic_vae_tpu_torch.train.step import sharded_epoch_indices

    data = generate_frames(PTRAIN_FRAMES, seed=30)[0]
    rng = np.random.default_rng(30)
    repl = np.stack([rng.permutation(PTRAIN_FRAMES)[:TRAIN_BATCH]
                     for _ in range(PTRAIN_STEPS)]).astype(np.int32)
    local = sharded_epoch_indices(rng, PTRAIN_FRAMES, TRAIN_BATCH, 2)[:PTRAIN_STEPS]
    owner = np.repeat(np.arange(2) * (PTRAIN_FRAMES // 2), TRAIN_BATCH // 2)[None, :]
    eps = rng.standard_normal((PTRAIN_STEPS, TRAIN_BATCH, 32)).astype(np.float32)
    return data, repl, local, (local + owner).astype(np.int32), eps


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms, for step-for-step training parity on
    the card (the default backward drifts run to run)."""
    import torch

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _free_port() -> int:
    """A free TCP port on this machine, for a process group's rendezvous."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ptrain_run(dev, critic, mesh, data, idx, eps, sharded=False):
    """(losses as numpy, state) of 3 float32 steps from ``numpy_vae_params(0)``
    on the card: ``make_multi_step`` (``mesh`` None or a mesh), or with
    ``sharded`` ``make_sharded_multi_step`` on this rank's rows of ``data``."""
    import torch

    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.parallel.mesh import row_slice
    from critic_vae_tpu_torch.train.step import (init_train_state, make_multi_step,
                                                 make_sharded_multi_step)

    state = init_train_state(*weights.numpy_vae_params(0), device=dev)
    if sharded:
        data = data[row_slice(mesh, len(data))]
        multi = make_sharded_multi_step(critic, mesh=mesh)
    else:
        multi = make_multi_step(critic, mesh=mesh)
    with _deterministic(), no_tf32():
        losses = multi(state, torch.from_numpy(data).to(dev), torch.from_numpy(idx).to(dev),
                       torch.from_numpy(eps).to(dev))
    return {k: v.cpu().numpy() for k, v in losses.items()}, state


def parallel_train_rank(rank: int, outdir: str, address: str) -> None:
    """Phase 30 (b)'s rank ``rank`` of 2: a gloo group, CUDA tensors on
    cuda:0, 3 steps of the replicated and of the sharded loop; each
    loop's losses, and whether the two ranks' parameters, BN stats and
    Adam moments are bitwise equal (compared by ``fetch``), into
    ``rank{rank}.npz``."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.parallel.distributed import init_distributed
    from critic_vae_tpu_torch.parallel.mesh import fetch, make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    require(init_distributed(address, num_processes=2, process_id=rank, device="cpu"),
            "no two-rank group")
    mesh = make_mesh(0, dev)
    require(mesh.size == 2 and mesh.device == dev
            and torch.distributed.get_backend() == "gloo", f"not a gloo mesh on the card: {mesh}")
    critic = weights.synthetic_models(dev)[0]
    data, repl, local, _, eps = _ptrain_inputs()
    out = {}
    for name, idx, sharded in (("repl", repl, False), ("shard", local, True)):
        losses, state = _ptrain_run(dev, critic, mesh, data, idx, eps, sharded)
        flat = torch.cat([t.detach().reshape(-1).float() for t in (
            state.params + state.mu + state.nu
            + [b for bn in state.vae.encoder.bns for b in (bn.running_mean, bn.running_var)])])
        both = fetch(mesh, flat[None])
        out.update({f"{name}/{k}": v for k, v in losses.items()})
        out[f"{name}/equal"] = np.array(bool(torch.equal(both[0], both[1])))
        out[f"{name}/values"] = np.array(flat.numel())
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def _torchrun(args, scratch: Path, timeout=300):
    """``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    critic_vae_tpu_torch ARGS`` in ``scratch``: (exit code, stdout lines,
    stderr, seconds)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           "-m", "critic_vae_tpu_torch", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=scratch,
                          env=env)
    lines = [ln for ln in proc.stdout.replace("\r", "\n").splitlines() if ln.strip()]
    return proc.returncode, lines, proc.stderr, time.perf_counter() - t0


def _step_windows(dev, runs: dict, data, rng) -> dict:
    """Each of ``runs`` (name -> ``run(idx) -> (K,) losses``) timed as
    PTRAIN_WINDOWS windows of TRAIN_CHUNK steps at batch 128, the variants in
    turn a window, after a warm-up each; then one torch.profiler run of 10
    steps each: ms a step (median), launches a step, the NCCL kernels'
    share of the device time, the idle share against the timed median, and
    the host time of the collectives a step (the c10d calls and the
    reductions' autograd nodes, from a CPU profile of 10 more steps)."""
    import numpy as np
    import torch

    def idx(k):
        return torch.from_numpy(np.stack([rng.permutation(len(data))[:TRAIN_BATCH]
                                          for _ in range(k)]).astype(np.int32)).to(dev)

    out = {name: {"window_ms": []} for name in runs}
    with no_tf32():
        for run in runs.values():
            run(idx(10))
        for _ in range(PTRAIN_WINDOWS):
            for name, run in runs.items():
                w = idx(TRAIN_CHUNK)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(w)
                torch.cuda.synchronize()
                out[name]["window_ms"].append(1e3 * (time.perf_counter() - t0) / TRAIN_CHUNK)
        for name, run in runs.items():
            w = idx(10)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                run(w)
                torch.cuda.synchronize()
            events = _device_ops(prof)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as host:
                run(w)
                torch.cuda.synchronize()
            comm_us = sum(e.self_cpu_time_total for e in host.key_averages()
                          if e.key in COLLECTIVE_HOST_OPS)
            kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
            nccl_ms = sum(e.self_device_time_total for e in events
                          if "nccl" in e.key.lower()) / 1e3
            r = out[name]
            r["step_ms"] = float(np.median(r["window_ms"]))
            r["launches"] = sum(e.count for e in events) / 10
            r["nccl_launches"] = sum(e.count for e in events if "nccl" in e.key.lower()) / 10
            r["kernel_ms"] = kernel_ms / 10
            r["nccl_share"] = nccl_ms / kernel_ms
            r["idle"] = max(0.0, 1.0 - kernel_ms / 10 / r["step_ms"])
            r["comm_host_ms"] = comm_us / 1e3 / 10
    return out


def phase_parallel_train(dev, critic, smi: str, scratch: Path):
    """30: data-parallel training at full width (critic-synthetic,
    ``numpy_vae_params(0)``, batch 128, float32, TF32 off, cuDNN
    deterministic for the parity parts). (a) a one-rank NCCL mesh in this
    process: 3 steps of ``make_multi_step`` with and without it from the
    same state and draws (losses within 1e-6 relative, parameters within
    0.25 lr, the encoder's conv biases 2 lr a step), ``make_sharded_multi_step``
    at D = 1 (bitwise the meshed replicated loop on the same rows), and 4
    alternating windows of 50 steps each way (ms a step, launches, the NCCL
    share, idle). (b) two spawned ranks on this card over gloo: 3 steps of
    the replicated and of the sharded loop (64 rows a rank) against (a)'s
    one-process steps on the equivalent global rows (losses within 1e-5
    relative, kld 5e-5: phase 23's bars), both ranks' states bitwise
    equal. (c) ``train`` (twice,
    resuming), ``dataset`` and ``second`` under ``torch.distributed.run
    --nproc-per-node 1`` (NCCL)."""
    import numpy as np
    import torch

    from critic_vae_tpu_torch.io import checkpoint as ckpt_io
    from critic_vae_tpu_torch.parallel.distributed import init_distributed
    from critic_vae_tpu_torch.parallel.mesh import make_mesh
    from critic_vae_tpu_torch.train.step import make_multi_step, state_tree

    t_phase = time.perf_counter()
    data, repl, local, global_sh, eps = _ptrain_inputs()

    def rel(got, want):  # each loss's largest relative error over the steps
        return {k: float(np.max(np.abs(got[k].astype(np.float64) / want[k] - 1))) for k in want}

    def show(errs):
        return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())

    # (b) first, so the two ranks run while (a) runs here
    bdir = scratch / "ranks"
    bdir.mkdir()
    address = f"127.0.0.1:{_free_port()}"
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            "chip_smoke.parallel_train_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])")
    t_b = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(bdir), address],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=scratch) for r in range(2)]
    try:
        # (a) the one-process references and a one-rank NCCL mesh in this process
        plain, plain_state = _ptrain_run(dev, critic, None, data, repl, eps)
        plain_sh, _ = _ptrain_run(dev, critic, None, data, global_sh, eps)
        require(not torch.distributed.is_initialized(), "a process group exists before phase 30")
        init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0,
                         device="cuda")
        try:
            mesh = make_mesh(1, dev)
            require(mesh.group is not None and torch.distributed.get_backend() == "nccl",
                    "no NCCL group")
            meshed, mesh_state = _ptrain_run(dev, critic, mesh, data, repl, eps)
            sh1, _ = _ptrain_run(dev, critic, mesh, data, repl, eps, sharded=True)
            a, b = state_tree(plain_state)["params"], state_tree(mesh_state)["params"]
            bias = {f"encoder.convs.{i}.bias" for i in range(4)}
            p_err = max(float(np.abs(a[k] - b[k]).max()) for k in a if k not in bias) / 5e-5
            b_err = max(float(np.abs(a[k] - b[k]).max()) for k in bias) / 5e-5
            bitwise = all(np.array_equal(meshed[k], plain[k]) for k in plain)
            sh_same = all(np.array_equal(sh1[k], meshed[k]) for k in meshed)
            log(f"[30 parallel train a] 3 f32 steps, batch {TRAIN_BATCH}, one-rank NCCL mesh "
                f"against none: losses within {show(rel(meshed, plain))} relative (bar "
                f"{PTRAIN_MESH_REL:g}; bitwise {bitwise}); parameters within "
                f"{p_err:.4f} lr (bar 0.25), the encoder's conv biases {b_err:.4f} lr (bar "
                f"{2 * PTRAIN_STEPS}); make_sharded_multi_step at D = 1 bitwise the meshed "
                f"loop on the same rows: {sh_same}; total_loss "
                f"{[round(float(v), 6) for v in meshed['total_loss']]}")
            require(max(rel(meshed, plain).values()) <= PTRAIN_MESH_REL and p_err <= 0.25
                    and b_err <= 2 * PTRAIN_STEPS and sh_same
                    and all(np.isfinite(v).all() for v in meshed.values()),
                    "the one-rank mesh's steps differ")
            del plain_state, mesh_state
            # the ranks share the card: they end before anything is timed
            outs = [pr.communicate(timeout=600)[0] for pr in procs]
            secs_b = time.perf_counter() - t_b

            from critic_vae_tpu_torch.io import weights
            from critic_vae_tpu_torch.train.step import init_train_state

            states = {k: init_train_state(*weights.numpy_vae_params(0), device=dev)
                      for k in ("plain", "mesh")}
            steps = {"plain": make_multi_step(critic), "mesh": make_multi_step(critic, mesh=mesh)}
            data_dev = torch.from_numpy(data).to(dev)
            t = _step_windows(dev, {k: (lambda idx, k=k: steps[k](states[k], data_dev, idx)
                                        ["total_loss"]) for k in steps},
                              data, np.random.default_rng(31))
            del states, steps, data_dev
        finally:
            torch.distributed.destroy_process_group()
        m, p = t["mesh"], t["plain"]
        for key, r in (("plain", p), ("mesh", m)):
            log(f"[30 parallel train a] {key}: ms a step {[round(v, 3) for v in r['window_ms']]}, "
                f"median {r['step_ms']:.3f}; {r['kernel_ms']:.3f} ms of kernels a step in "
                f"{r['launches']:.0f} launches ({r['nccl_launches']:.0f} NCCL, "
                f"{r['nccl_share']:.2%} of the device time); device idle {r['idle']:.1%}; the "
                f"collectives' host time {r['comm_host_ms']:.3f} ms a step under the profiler")
        log(f"[30 parallel train a] mesh/plain {m['step_ms'] / p['step_ms']:.4f} (medians); "
            f"the mesh adds {m['launches'] - p['launches']:.0f} launches a step; {smi}")
    finally:
        for pr in procs:
            pr.kill()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        require(pr.returncode == 0, f"phase 30 rank {r} failed:\n{out[-3000:]}")
    ranks = [dict(np.load(bdir / f"rank{r}.npz")) for r in range(2)]
    for name, want in (("repl", plain), ("shard", plain_sh)):
        got = [{k: g[f"{name}/{k}"] for k in want} for g in ranks]
        errs = {k: max(rel(g, want)[k] for g in got) for k in want}
        equal = [bool(g[f"{name}/equal"]) for g in ranks]
        log(f"[30 parallel train b] two gloo ranks on one card, {name} loop "
            f"({TRAIN_BATCH // 2} rows a rank): losses within {show(errs)} relative of one "
            f"process on the same global rows (phase 23's bars {TRAIN_LOSS_REL}); the ranks' "
            f"{int(ranks[0][f'{name}/values'])} state values bitwise equal by fetch: {equal}")
        require(all(v <= TRAIN_LOSS_REL[k] for k, v in errs.items()) and all(equal),
                f"two ranks' {name} loop differs")
    log(f"[30 parallel train b] the two ranks' processes took {secs_b:.1f} s")

    # (c) the commands under the launcher, one NCCL rank
    root = scratch / "root_ptrain"
    root.mkdir()
    train_args = ["train", "--device", "cuda", "--source", "synthetic:1:1024", "--epochs", "1",
                  "--batch-size", str(TRAIN_BATCH), "--root", str(root), "--log-dir",
                  str(root / "logs")]
    for label, args in (("train", train_args), ("train again", train_args),
                        ("dataset", ["dataset", "--device", "cuda", "--source",
                                     "synthetic:1:1024", "--root", str(root)]),
                        ("second", ["second", "--device", "cuda", "--epochs", "1",
                                    "--batch-size", str(TRAIN_BATCH), "--root", str(root)])):
        rc, lines, err, secs = _torchrun(args, scratch)
        shown = lines if len(lines) <= 5 else lines[:3] + ["..."] + lines[-2:]
        log(f"[30 parallel train c] torch.distributed.run --nproc-per-node 1 {label}: exit {rc} "
            f"in {secs:.1f} s; " + " | ".join(shown))
        require(rc == 0 and lines[0] == "multi-host: 1 processes, 1 devices",
                f"torchrun {label} failed: {err[-3000:]}")
        if label == "train":
            ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
            events = sorted(p.name.split(".")[0] for p in (root / "logs").iterdir())
            arts = sorted(p.name for p in (root / "saved-networks").iterdir())
            log(f"[30 parallel train c] checkpoints {ckpts}; logs {events}; artifacts {arts}")
            require(len(ckpts) == 2 and events == ["events", "metrics"]
                    and arts == ["vae_decoder.ckpt", "vae_encoder.ckpt"],
                    "train under the launcher wrote other files")
            first = ckpt_io.latest_checkpoint(str(root / "checkpoints"))
        if label == "train again":
            require(any(ln.startswith("resumed from") for ln in lines)
                    and ckpt_io.latest_checkpoint(str(root / "checkpoints"))[1] == first[1],
                    "the second train did not resume")
    require((root / "vae2_encoder.ckpt").is_file(), "second wrote no artifacts")
    log(f"[30 parallel train] phase 30 took {time.perf_counter() - t_phase:.1f} s; {smi}")
    return t


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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one card.")
    ap.add_argument("--bf16-golden-only", action="store_true",
                    help="run only the card's identity, the build and phase 17")
    ap.add_argument("--train-only", action="store_true",
                    help="run only the card's identity, the build and phases 23-24")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run only the card's identity, the build and phases 29-30")
    ap.add_argument("--port", type=Path, default=ROOT,
                    help="directory holding the critic_vae_tpu_torch package to drive "
                         "(default: this script's; the goldens are always this script's)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    port = args.port.resolve()
    if not (port / "critic_vae_tpu_torch").is_dir() or not (ROOT / "tests" / "golden").is_dir():
        print(f"chip_smoke: no critic_vae_tpu_torch package in {port}, or no tests/golden "
              f"beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(port))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.bf16_golden_only:
        from critic_vae_tpu_torch.io.weights import synthetic_models

        phase_identity()
        phase_build()
        phase_bf16_golden(dev, synthetic_models(dev)[0])
        return 0
    if args.parallel_only:
        import tempfile

        from critic_vae_tpu_torch.io.weights import synthetic_models

        smi = phase_identity()
        phase_build()
        critic, vae = synthetic_models(dev)
        with tempfile.TemporaryDirectory() as scratch:
            phase_parallel(dev, critic, vae, smi, Path(scratch))
        with tempfile.TemporaryDirectory() as scratch:
            phase_parallel_train(dev, critic, smi, Path(scratch))
        return 0
    if args.train_only:
        from critic_vae_tpu_torch.io.weights import synthetic_models

        phase_identity()
        phase_build()
        critic = synthetic_models(dev)[0]
        phase_train_golden(dev, critic)
        phase_train_throughput(dev, critic)
        return 0

    smi = phase_identity()
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
    phase_decoder(dev, critic, vae)
    phase_xla(dev)
    phase_host_crf(dev, critic, vae)
    import tempfile

    with tempfile.TemporaryDirectory() as scratch:
        phase_cli(dev, Path(scratch))
    phase_bf16_golden(dev, critic)
    gold_frames, gold_gt, thr_gold = phase_quality_golden(dev, critic, vae)
    phase_saliency_stage(dev, critic, vae)
    from critic_vae_tpu_torch.data.synthetic import generate_frames

    with tempfile.TemporaryDirectory() as scratch:
        res_q, lq = phase_quality_main(dev, critic, vae, Path(scratch))
    ls, _ = phase_search(dev, gold_frames, gold_gt, thr_gold, res_q,
                         *generate_frames(MAIN_FRAMES, seed=0))
    ld, b4_l3 = phase_densecrf(dev)
    phase_train_golden(dev, critic)
    train_runs = phase_train_throughput(dev, critic)
    with tempfile.TemporaryDirectory() as scratch:
        le, b1_eval_err = phase_train_commands(dev, critic, Path(scratch))
    with tempfile.TemporaryDirectory() as scratch:
        lm, _ = phase_distill(dev, critic, smi, Path(scratch), train_runs["float32"])
        phase_critic_train(dev, smi, Path(scratch))
        phase_data_export(dev, critic, smi, Path(scratch))
    with tempfile.TemporaryDirectory() as scratch:
        lp = phase_parallel(dev, critic, vae, smi, Path(scratch))
    with tempfile.TemporaryDirectory() as scratch:
        phase_parallel_train(dev, critic, smi, Path(scratch))
    launches = {k: launches[k] + lq[k] + ls[k] + ld[k] + le[k] + lm[k] + lp[k]
                for k in launches}
    b1 = {**b1, "max_abs_err": max(b1["max_abs_err"], b1_eval_err)}
    b4 = {**b4, **b4_l3, "max_abs_err": max(b4["max_abs_err"], b4_l3["max_abs_err_l3"])}
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
