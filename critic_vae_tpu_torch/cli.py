"""Command line of the port: ``python -m critic_vae_tpu_torch video ...``.

The ``video`` subcommand is the mask-video path of the JAX package's
``video`` mode (critic_vae_tpu/cli.py ``cmd_video``) without
reconstructions, panels or GIFs: critic, VAE double decode, diff maps,
normalisation, threshold, device CRF, and the whole-stack IoUs printed as
``thr_iou=`` / ``crf_iou=``. With ``--sweep`` (reference: -thresh) it runs
the threshold sweep instead and prints one ``thr=, thr_iou=, crf_iou=``
line per threshold. The CRF backend is resolved once, before any weights
load, as in the JAX package: ``--crf-backend auto`` prints ``crf backend:
device (auto)``, and a backend that cannot run here (``auto`` off CUDA
resolves to the host CRF, not ported yet) prints ``error: ...`` and exits
with 1. The device CRF's build is chosen, as in the JAX package, by
``CRITIC_VAE_TPU_CRF_BUILD`` (auto|pallas|int8|vmem), and its per-chunk
memory budget by ``CRITIC_VAE_TPU_CRF_MEM`` (bytes, default 6 GiB).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

DEFAULT_CRITIC = Path(__file__).resolve().parent.parent / "saved-networks" / "critic-synthetic.npz"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="critic_vae_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    v = sub.add_parser("video", help="mask-video pipeline (reference: -video)")
    v.add_argument("--episode", required=True, help="episode dir with X.npy (and Y.npy)")
    v.add_argument("--no-slice", action="store_true",
                   help="use every frame instead of the reference's [100:5000:2] slice")
    v.add_argument("--critic", default=str(DEFAULT_CRITIC), help="critic .npz (JAX flat format)")
    vae = v.add_mutually_exclusive_group()
    vae.add_argument("--vae", default=None, help="VAE .npz (io/weights.py format)")
    vae.add_argument("--vae-seed", type=int, default=0,
                     help="random VAE weights from this seed (numpy_vae_params)")
    v.add_argument("--threshold", type=int, default=50)
    v.add_argument("--sweep", action="store_true", help="threshold sweep 0..120 (reference: -thresh)")
    v.add_argument("--sweep-range", default=None, metavar="LO:HI[:STEP]",
                   help="the sweep's thresholds, HI inclusive (default 0:120:10); implies --sweep")
    v.add_argument("--batch-size", type=int, default=512)
    v.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    v.add_argument("--crf-backend", default="auto", choices=["auto", "device"])
    v.add_argument("--no-crf", action="store_true")
    v.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _parse_sweep_range(spec: str) -> list:
    """'LO:HI[:STEP]' -> thresholds, HI inclusive, uint8 range (as the JAX
    package's cli._parse_sweep_range)."""
    parts = spec.split(":")
    try:
        lo, hi = int(parts[0]), int(parts[1])
        step = int(parts[2]) if len(parts) > 2 else 10
        if len(parts) > 3:
            raise ValueError
    except (ValueError, IndexError):
        raise SystemExit(f"bad --sweep-range {spec!r}; expected LO:HI or LO:HI:STEP (integers)")
    if not (0 <= lo <= hi <= 255) or step < 1:
        raise SystemExit(
            f"bad --sweep-range {spec!r}; need 0 <= LO <= HI <= 255 "
            "(thresholds apply to uint8 maps) and STEP >= 1"
        )
    return list(range(lo, hi + 1, step))


def cmd_video(args) -> int:
    from critic_vae_tpu_torch.data.episode import DEFAULT_SLICE, load_episode
    from critic_vae_tpu_torch.device import resolve_device
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines.video import DEFAULT_SWEEP, eval_episode, threshold_sweep

    thresholds = DEFAULT_SWEEP
    if args.sweep_range is not None:
        args.sweep = True
        thresholds = _parse_sweep_range(args.sweep_range)
    device = resolve_device(args.device)
    frames, gt = load_episode(args.episode, None if args.no_slice else DEFAULT_SLICE)
    if len(frames) == 0:
        print("error: the episode slice selects 0 frames; try --no-slice", file=sys.stderr)
        return 1
    if args.sweep and gt is None:
        print("error: --sweep needs IoU scoring, and the episode has no Y.npy",
              file=sys.stderr)
        return 1
    if not args.no_crf:
        # resolve 'auto' (and check an explicit 'device') against the
        # episode's resolution and the device once, before any weights load
        from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

        try:
            backend = resolve_crf_backend(args.crf_backend, frames.shape[1], frames.shape[2],
                                          device=device)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if args.crf_backend == "auto":
            print(f"crf backend: {backend} (auto)")
        args.crf_backend = backend
    critic = weights.critic_from_params(weights.load_critic_npz(args.critic)).to(device)
    params, state = (weights.load_vae_npz(args.vae) if args.vae
                     else weights.numpy_vae_params(args.vae_seed))
    vae = weights.vae_from_params(params, state).to(device)
    print(f"processing {len(frames)} frames on {device}...")
    if args.sweep:
        print("testing thresholds (thr):")
        results = threshold_sweep(
            vae, critic, frames, gt, thresholds, device=device, run_crf=not args.no_crf,
            batch_size=args.batch_size, compute_dtype=args.dtype, crf_backend=args.crf_backend,
        )
        for r in results:
            print(f"thr={r['threshold']}, thr_iou={r['thr_iou']}, crf_iou={r['crf_iou']}")
        return 0
    result = eval_episode(
        vae, critic, frames, gt, device=device, threshold=args.threshold,
        run_crf=not args.no_crf, batch_size=args.batch_size,
        compute_dtype=args.dtype, crf_backend=args.crf_backend,
    )
    if gt is None:
        print("no Y.npy ground truth: IoU scoring skipped")
    else:
        print(f"thr_iou={result.thr_iou}")
        print(f"crf_iou={result.crf_iou}")
    return 0


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"video": cmd_video}[args.command](args)
