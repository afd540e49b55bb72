"""Command line of the port: ``python -m critic_vae_tpu_torch
{video,train,eval,inject,evalsecond,traincritic,dataset,second,export} ...``,
the JAX package's modes of the same names (critic_vae_tpu/cli.py).

``train`` collects a balanced training set from ``--source``
(``synthetic[:N[:T]]`` or a directory of ``.npy`` trajectories) with the
critic, trains the VAE (checkpoints under ``--root``/checkpoints, resumed
unless ``--no-resume``, TensorBoard events and a JSONL mirror under
``--log-dir``), and writes the encoder and decoder artifacts in the JAX
package's layout to ``--root``/saved-networks/vae_{encoder,decoder}.ckpt,
which ``eval``, ``inject`` and ``video`` read. It starts from
``numpy_vae_params(--seed)``, not the JAX package's threefry draw.
``--mask-distill W`` first builds pseudo-label masks of the collected
frames (pipelines/distill.py: LayerCAM + the CAM-tuned CRF) and trains with
the soft-Dice term at weight W. Over more than one rank it trains
data-parallel (pipelines/train.py): the dataset is sharded over the ranks
when they divide its frames and the batch, and ``--no-shard-dataset``
replicates it on every rank instead, which also changes the shuffle stream
(one global permutation an epoch, not one a shard) and is recorded in the
resume meta.

``traincritic`` trains a critic on ``--episodes`` (X.npy + Y.npy episode
dirs; labels from the masks) or ``--synthetic-frames`` synthetic frames,
with soft or binary labels, optionally the best of ``--cam-select N`` seeds
by the no-ground-truth LayerCAM health (train/critic.py), and writes the
JAX package's flat ``.npz`` (default ``--root``/saved-networks/critic.npz).
As in the JAX package, ``--cam-health-target`` takes effect only with
``--cam-select`` > 1. ``dataset`` writes the reconstruction dataset of
``--source`` (default ``--root``/recon-dataset.npz); ``second`` trains a
VAE on it and writes ``--root``/vae2_{encoder,decoder}.ckpt, which
``evalsecond`` reads; ``export`` writes the VAE (``--encoder-out`` with
``--decoder-out``) and the critic (``--critic-out``) as the reference's
torch ``state_dict`` files (``torch.save``), and refuses a FiLM decoder.

``eval`` (``evalsecond``: the second VAE's ``vae2_*.ckpt``) writes a
4-panel strip a still of ``--images`` (default ``--root``/source-images) to
``--out`` (default ``--root``/images); ``inject`` writes each still beside
its reconstructions at ``--values`` (default 0,0.2,…,1) to ``--out``
(default ``--root``/inject).

The ``video`` subcommand is the JAX package's ``video`` mode
(critic_vae_tpu/cli.py ``cmd_video``): critic, VAE double decode, diff
maps (or with ``--mask-source saliency`` and the ``--saliency-*`` flags the
critic's saliency maps), normalisation, threshold, dense CRF,
the whole-stack IoUs printed as ``thr_iou=`` / ``crf_iou=``,
``bin_info_vae1.txt`` under ``--root`` when the episode has Y.npy, and the
annotated GIF ``videos/video-threshold=T.gif`` under ``--root`` unless
``--no-gif``. Without Pillow it acts as with ``--no-gif`` and prints one
line saying why. With ``--sweep`` (reference:
-thresh) it runs the threshold sweep and prints one ``thr=, thr_iou=,
crf_iou=`` line per threshold.

Defaults come from ``config.py`` (the JAX package's ``config.py``), paths
under ``--root``. ``video`` reads ``--episode``, by default
``--root``/minerl-episode. Its VAE is ``--encoder/--decoder`` (the JAX
package's ``train`` artifacts, FiLM decoders included), by default
``--root``/saved-networks/vae_{encoder,decoder}.ckpt, read strictly: a
missing file raises, as in the JAX package. Two options are the port's own:
``--vae`` (a combined ``.npz``) and ``--vae-seed S`` (random weights,
``numpy_vae_params(S)``). ``--critic`` is a ``.npz`` or the reference's
torch ``.pt``; its default is a deviation: the repo's synthetic critic
``saved-networks/critic-synthetic.npz``, whatever ``--root``, where the JAX
package's is the reference's critic under ``--root``
(PathConfig.critic_path), a file the repo does not hold. The CRF backend is
resolved once, before any weights load: ``--crf-backend auto`` prints
``crf backend: device (auto)`` or ``host (auto)``, and a backend that
cannot run prints ``error: ...`` and exits with 1. ``--crf-params``
replaces the reference's CRF tuple. The device CRF's build is chosen, as in
the JAX package, by ``CRITIC_VAE_TPU_CRF_BUILD``
(auto|xla|pallas|int8|vmem), and its per-chunk memory budget by
``CRITIC_VAE_TPU_CRF_MEM`` (bytes, default 6 GiB).

Every command takes the JAX package's ``--seed`` (where the JAX package
only seeds the template its weights load into, it has no effect here) and
``--profile DIR``, which ``video`` honours: a ``torch.profiler`` trace of
its run (the sweep, or the episode) under DIR (utils/profiling.py), with
the port's spans: an episode's ``video.episode`` holding ``video.upload``,
``video.device_stage``, ``video.normalize``, ``video.crf``,
``video.readback`` and ``video.score``; each device CRF chunk's
``crf.build`` and ``crf.mean_field``; under ``--num-devices`` the mesh's
``mesh.all_gather``; and each hand-written kernel's launch under its name
(``diff_mask``, ``bilateral_build``, ``kernel_i8_build``, ``matvec_i8``,
``mean_field_resident``). ``--device cpu`` runs on the CPU; the card is
the default.

Ranks: ``main`` forms the ``torch.distributed`` group first when a launcher
set one up (parallel/distributed.py: ``python -m torch.distributed.run
--nproc-per-node N -m critic_vae_tpu_torch ...``; NCCL on the card, gloo
with ``--device cpu``), and the primary prints ``multi-host: N processes, N
devices``. Every rank computes; only rank 0 writes files and prints
results. ``video --num-devices N`` shards the device stage and the device
CRF over an N-rank mesh (0: every rank; parallel/mesh.py, one device a
rank, so N must be the number of ranks). ``train`` and ``second`` train
data-parallel over every rank, with the global batch's BatchNorm and
losses (train/step.py); every rank collects the same training set (and
builds the same pseudo masks) from the same source.

``--quality`` expands into the JAX package's measured-best chain (LayerCAM,
{id, mirror} x {0, +-2 px} TTA, the CAM-tuned CRF, threshold 64), a flag set
to another value than its default winning over the preset.
``--crf-search [GRID]`` searches the CRF parameters on the device CRF
(crf/device.py::crf_param_search), prints one ``  iou=...  (w1=..., ...)``
line a combination in descending IoU, and refines with the best; it cannot
go with ``--sweep`` or ``--crf-params`` (``error: ...``, exit 1). Every flag
is parsed and checked before any weights load.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional

from critic_vae_tpu_torch.config import Config, default_config

# the repo's synthetic critic: --critic's default, whatever --root (the JAX
# package's default, the reference's critic, is not in the repo)
DEFAULT_CRITIC = Path(__file__).resolve().parent.parent / "saved-networks" / "critic-synthetic.npz"
CRITIC_OUT_PATH = "saved-networks/critic.npz"

# argparse defaults come from the typed config, as the JAX package's
_D = default_config()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="critic_vae_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    v = sub.add_parser("video", help="mask-video pipeline (reference: -video)")
    _add_common(v)
    v.add_argument("--episode", default=None,
                   help="episode dir with X.npy (and Y.npy); default --root/minerl-episode")
    v.add_argument("--no-slice", action="store_true",
                   help="use every frame instead of the reference's [100:5000:2] slice")
    vae = v.add_mutually_exclusive_group()
    vae.add_argument("--encoder", default=None,
                     help="encoder artifact of the JAX package's train (with --decoder); "
                     "default --root/saved-networks/vae_encoder.ckpt and vae_decoder.ckpt")
    vae.add_argument("--vae", default=None, help="VAE .npz (io/weights.py format)")
    vae.add_argument("--vae-seed", type=int, default=None,
                     help="random VAE weights from this seed (numpy_vae_params) instead of "
                     "the artifacts")
    v.add_argument("--decoder", default=None,
                   help="decoder artifact of the JAX package's train (with --encoder)")
    v.add_argument("--threshold", type=int, default=_D.mask.threshold,
                   help="mask threshold on the normalized uint8 maps (default %(default)s)")
    v.add_argument("--quality", action="store_true",
                   help="the JAX package's measured-best mask chain in one flag: "
                   "--mask-source saliency --saliency-method layercam --saliency-tta-flip "
                   "--saliency-tta-shift 2 --crf-params 132,32,3.1,8,1.8,10 --threshold 64; "
                   "a flag of the chain set to another value than its default wins")
    v.add_argument("--sweep", action="store_true", help="threshold sweep 0..120 (reference: -thresh)")
    v.add_argument("--sweep-range", default=None, metavar="LO:HI[:STEP]",
                   help="the sweep's thresholds, HI inclusive (default 0:120:10); implies --sweep")
    v.add_argument("--batch-size", type=int, default=512)
    v.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    v.add_argument("--crf-backend", default="auto", choices=["auto", "host", "device"],
                   help="'host': the C++ lattice; 'device': the exact mean field on the "
                   "card; 'auto': device on CUDA at <= 128x128, else host")
    v.add_argument("--crf-params", default=None, metavar="W1,ALPHA,BETA,W2,GAMMA,ITERS",
                   help="explicit CRF parameter 6-tuple (default: the reference's "
                   "22,12,3.1,8,1.8,10)")
    v.add_argument("--crf-search", nargs="?", const="", default=None, metavar="GRID",
                   help="search the CRF parameters on the device CRF and refine with the "
                   "best combination; GRID like 'w1=11,22,44;beta=1.55,3.1;w2=4,8' (a "
                   "missing key takes the reference's value; default w1 x beta x w2, 3x3x3)")
    v.add_argument("--mask-source", default="diff", choices=["diff", "saliency"],
                   help="'diff': the reference's VAE reconstruction difference; "
                   "'saliency': the critic's saliency maps (ops/saliency.py)")
    v.add_argument("--saliency-method", default="gradient", choices=["gradient", "layercam"],
                   help="saliency: |d score / d x| at the pixels, or LayerCAM over a block's "
                   "post-pool activation, upsampled")
    v.add_argument("--saliency-cam-block", type=int, default=1, metavar="K",
                   help="layercam: the post-pool critic block to tap (0-3)")
    v.add_argument("--saliency-cam-upsample", default="lanczos3",
                   choices=["bilinear", "bicubic", "lanczos3", "nearest"],
                   help="layercam: the interpolation kernel up to the frame")
    v.add_argument("--saliency-logits", action="store_true",
                   help="saliency: differentiate the critic's pre-sigmoid logit")
    v.add_argument("--saliency-samples", type=int, default=1, metavar="N",
                   help="saliency: SmoothGrad sample count")
    v.add_argument("--saliency-noise", type=float, default=0.0, metavar="STD",
                   help="saliency: SmoothGrad input-noise std in [0, 1] pixel units")
    v.add_argument("--saliency-seed", type=int, default=0,
                   help="saliency: base seed of the SmoothGrad noise generators")
    v.add_argument("--saliency-sigma", type=float, default=None, metavar="SIGMA",
                   help="saliency: Gaussian smoothing sigma in pixels, 0 for none (default "
                   "1.5 for gradient, 0 for layercam)")
    v.add_argument("--saliency-tta-flip", action="store_true",
                   help="saliency: min-combine with the map of the mirrored frames")
    v.add_argument("--saliency-tta-shift", type=int, default=0, metavar="D",
                   help="saliency: min-combine with the maps of the +-D px horizontally "
                   "shifted views (with --saliency-tta-flip the {id,mirror}x{0,+-D} product)")
    v.add_argument("--no-crf", action="store_true")
    v.add_argument("--no-gif", action="store_true")
    v.add_argument("--num-devices", type=int, default=None, metavar="N",
                   help="shard the device stage and the device CRF over an N-rank mesh, one "
                   "device a rank (0: every rank; N must be the number of ranks; default: "
                   "no mesh)")
    _add_train(sub)
    for name, help_ in (("eval", "evaluate source images (reference default mode)"),
                        ("inject", "injection ladder strips (reference: -inject)"),
                        ("evalsecond", "evaluate with the second VAE's weights "
                                       "(reference: -evalsecond)")):
        e = sub.add_parser(name, help=help_)
        _add_common(e)
        e.add_argument("--encoder", default=None, help="encoder artifact (.ckpt)")
        e.add_argument("--decoder", default=None, help="decoder artifact (.ckpt)")
        e.add_argument("--images", default=None, help="source images directory")
        e.add_argument("--out", default=None, help="output directory")
        if name == "inject":
            e.add_argument("--values", default=None,
                           help="comma-separated critic values to inject "
                           "(default: 0,0.2,0.4,0.6,0.8,1 — reference vae_nets.py:31)")
    _add_data_commands(sub)
    return p


def _add_vae_weights(p: argparse.ArgumentParser) -> None:
    p.add_argument("--encoder", default=None, help="encoder artifact (.ckpt)")
    p.add_argument("--decoder", default=None, help="decoder artifact (.ckpt)")


def _add_data_commands(sub) -> None:
    """``dataset``, ``second``, ``traincritic`` and ``export``, with the JAX
    package's flags and defaults."""
    d = sub.add_parser("dataset", help="build recon dataset (reference: -dataset)")
    _add_common(d)
    _add_vae_weights(d)
    d.add_argument("--source", default="synthetic")
    d.add_argument("--out", default=None, help="output .npz path")
    d.add_argument("--total-images", type=int, default=_D.train.total_images)

    s = sub.add_parser("second", help="train second VAE on recon dataset (reference: -second)")
    _add_common(s, seed_help=TRAIN_SEED_HELP)
    s.add_argument("--dataset", dest="dataset_path", default=None)
    s.add_argument("--epochs", type=int, default=_D.train.epochs)
    s.add_argument("--batch-size", type=int, default=_D.train.batch_size)
    s.add_argument("--lr", type=float, default=_D.train.learning_rate)
    s.add_argument("--correct-msssim", action="store_true",
                   help="train with textbook MS-SSIM instead of the reference's variant")

    tc = sub.add_parser("traincritic", help="train a critic from labeled episodes")
    _add_common(tc, seed_help="seed of the synthetic frames and of the critic's training "
                "(with --cam-select N, the first of N seeds)")
    tc.add_argument("--episodes", default=None,
                    help="directory of episode dirs (X.npy + Y.npy); labels derive from Y "
                    "masks. Default: synthetic data")
    tc.add_argument("--synthetic-frames", type=int, default=12800)
    tc.add_argument("--epochs", type=int, default=15)
    tc.add_argument("--batch-size", type=int, default=128)
    tc.add_argument("--lr", type=float, default=1e-3)
    tc.add_argument("--dropout", type=float, default=0.3)
    tc.add_argument("--labels", choices=("soft", "binary"), default="soft",
                    help="'soft' trunk-area fractions (train/critic.py::soft_trunk_labels) "
                    "or 'binary' visibility")
    tc.add_argument("--no-cam-health", action="store_true",
                    help="skip the post-training no-GT LayerCAM health report")
    tc.add_argument("--cam-select", type=int, default=1, metavar="N",
                    help="train N candidate critics (seeds seed..seed+N-1) and keep the best "
                    "by the no-GT deletion_drop health metric")
    tc.add_argument("--cam-health-target", type=float, default=None, metavar="D",
                    help="with --cam-select N: stop as soon as a candidate's deletion_drop "
                    "reaches D; if none does, the best is kept and a warning printed")
    tc.add_argument("--out", default=None, help="output critic .npz path")

    x = sub.add_parser("export", help="export weights as torch .pt state_dicts loadable by "
                       "the reference")
    _add_common(x)
    _add_vae_weights(x)
    x.add_argument("--encoder-out", default=None,
                   help="torch .pt path for the encoder state_dict")
    x.add_argument("--decoder-out", default=None,
                   help="torch .pt path for the decoder state_dict")
    x.add_argument("--critic-out", default=None,
                   help="also export the critic (from --critic) as a torch .pt state_dict")


TRAIN_SEED_HELP = "seed of the initial weights, the noise and the shuffle"


def _add_common(p: argparse.ArgumentParser, seed_help: str = (
        "accepted as in the JAX package, where it only seeds the template the weights "
        "load into: no effect here")) -> None:
    """The JAX package's common flags (its cli.py ``_add_common``), with
    ``--critic``'s default the repo's synthetic critic (the module's note),
    and the port's ``--device``."""
    p.add_argument("--root", default=".", help="working directory (paths resolve against it)")
    p.add_argument("--critic", default=str(DEFAULT_CRITIC),
                   help="critic: .npz (JAX flat format) or the reference's torch .pt "
                   "(default: the repo's saved-networks/critic-synthetic.npz)")
    p.add_argument("--seed", type=int, default=_D.train.seed, help=seed_help)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of video's run into DIR (the other "
                   "commands take no trace)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def _add_train(sub) -> None:
    t = sub.add_parser("train", help="train the VAE (reference: -train)")
    _add_common(t, seed_help=TRAIN_SEED_HELP)
    t.add_argument("--source", default="synthetic",
                   help="trajectory source: synthetic[:N[:T]] | minerl:<root> | <npy dir>")
    t.add_argument("--epochs", type=int, default=_D.train.epochs)
    t.add_argument("--batch-size", type=int, default=_D.train.batch_size)
    t.add_argument("--lr", type=float, default=_D.train.learning_rate)
    t.add_argument("--kld-weight", type=float, default=_D.train.kld_weight)
    t.add_argument("--total-images", type=int, default=_D.train.total_images)
    t.add_argument("--no-resume", action="store_true")
    t.add_argument("--log-dir", default=None)
    t.add_argument("--log-images", action="store_true",
                   help="log an originals-vs-reconstructions probe strip every epoch")
    t.add_argument("--correct-msssim", action="store_true",
                   help="train with textbook MS-SSIM instead of the reference's variant")
    t.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="conv/matmul compute dtype of the train step (params, Adam "
                   "state, BN stats and the loss stay float32)")
    t.add_argument("--value-consistency", type=float, default=0.0, metavar="W",
                   help="weight of the auxiliary loss that the frozen critic read "
                   "decode(mu, 0) as 0 and decode(mu, v) as v; 0 = off")
    t.add_argument("--mask-distill", type=float, default=0.0, metavar="W",
                   help="weight of the self-distillation term: pseudo-label masks from the "
                   "frozen critic (LayerCAM + CAM-tuned CRF, pipelines/distill.py) and a "
                   "soft-Dice loss pushing the recon-diff signal into them; 0 = off")
    t.add_argument("--no-shard-dataset", action="store_true",
                   help="replicate the device-resident dataset on every rank instead of "
                   "sharding it over the ranks (sharding is automatic when dataset and "
                   "batch divide by the number of ranks); changes the shuffle stream")
    t.add_argument("--film", action="store_true",
                   help="zero-initialised FiLM (gamma, beta) per decoder stage from the "
                   "critic value")


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


def _parse_crf_params(spec: str) -> tuple:
    """'w1,alpha,beta,w2,gamma,iters' -> the CRF 6-tuple (as the JAX
    package's cli._parse_crf_params)."""
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) != 6:
        raise SystemExit(
            f"bad --crf-params {spec!r}: expected 6 comma-separated values "
            "(w1,alpha,beta,w2,gamma,iters)"
        )
    try:
        return tuple([float(v) for v in parts[:5]] + [int(parts[5])])
    except ValueError:
        raise SystemExit(
            f"bad --crf-params {spec!r}: first five must be numbers, iters an integer"
        )


def _parse_crf_grid(spec: str) -> dict:
    """'w1=11,22;beta=1.55,3.1' -> a crf_param_search grid; an empty spec is
    the default 3x3x3 grid over (w1, beta, w2) (as the JAX package's
    cli._parse_crf_grid)."""
    if not spec:
        return {"w1": [11.0, 22.0, 44.0], "beta": [1.55, 3.1, 6.2], "w2": [4.0, 8.0, 16.0]}
    valid = {"w1", "alpha", "beta", "w2", "gamma", "iters"}
    grid = {}
    for part in spec.split(";"):
        key, _, vals = part.partition("=")
        key = key.strip()
        if key not in valid or not vals:
            raise SystemExit(
                f"bad --crf-search component {part!r}; expected key=v1,v2,... "
                f"with key in {sorted(valid)}"
            )
        cast = int if key == "iters" else float
        try:
            grid[key] = [cast(v) for v in vals.split(",")]
        except ValueError:
            raise SystemExit(
                f"bad --crf-search component {part!r}; values must be "
                f"{'integers' if key == 'iters' else 'numbers'}"
            )
    return grid


# the measured-best chain: argparse dest -> (parser default, preset value)
_QUALITY_PRESET = {
    "mask_source": ("diff", "saliency"),
    "saliency_method": ("gradient", "layercam"),
    "saliency_tta_flip": (False, True),
    "saliency_tta_shift": (0, 2),
    "crf_params": (None, "132,32,3.1,8,1.8,10"),
    "threshold": (50, 64),
}


def _apply_quality_preset(args) -> None:
    """Expand ``--quality`` into the chain's flags, as the JAX package does:
    a flag whose parsed value differs from its default wins over the preset,
    and with ``--crf-search`` the CRF parameters are left to the search."""
    for dest, (default, preset) in _QUALITY_PRESET.items():
        if dest == "crf_params" and args.crf_search is not None:
            continue
        if getattr(args, dest) == default:
            setattr(args, dest, preset)


def _cfg(args) -> Config:
    return default_config(args.root)


def _primary() -> bool:
    from critic_vae_tpu_torch.parallel.distributed import is_primary

    return is_primary()


def _load_vae(args, cfg: Config):
    """(params, bn_state) of ``video``: --vae, --vae-seed, else the ``train``
    artifacts (--encoder/--decoder, by default under --root), read
    strictly."""
    from critic_vae_tpu_torch.io import weights

    if args.vae is not None:
        return weights.load_vae_npz(args.vae)
    if args.vae_seed is not None:
        return weights.numpy_vae_params(args.vae_seed)
    return _final_vae(args, cfg)


def cmd_video(args) -> int:
    from critic_vae_tpu_torch.data.episode import load_episode
    from critic_vae_tpu_torch.device import resolve_device
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines import video as vid
    from critic_vae_tpu_torch.utils.profiling import profile_trace

    cfg = _cfg(args)
    pri = _primary()  # every rank runs the stages; only the primary writes
    if (args.encoder is None) != (args.decoder is None):
        print("error: --encoder and --decoder go together", file=sys.stderr)
        return 1
    if args.quality:
        _apply_quality_preset(args)
    thresholds = cfg.mask.threshold_sweep
    if args.sweep_range is not None:
        args.sweep = True
        thresholds = _parse_sweep_range(args.sweep_range)
    searching = args.crf_search is not None
    if args.sweep and searching:
        print("error: --sweep and --crf-search are mutually exclusive "
              "(the sweep varies the threshold, the search varies CRF "
              "parameters at one threshold)", file=sys.stderr)
        return 1
    if args.crf_params is not None and searching:
        print("error: --crf-params and --crf-search are mutually exclusive "
              "(the search finds parameters; pass its winner back via "
              "--crf-params)", file=sys.stderr)
        return 1
    search_grid = _parse_crf_grid(args.crf_search) if searching else None
    crf_params = (_parse_crf_params(args.crf_params) if args.crf_params is not None
                  else cfg.mask.crf_params)
    saliency_opts = {
        "logits": args.saliency_logits, "samples": args.saliency_samples,
        "noise": args.saliency_noise, "seed": args.saliency_seed,
        "sigma": args.saliency_sigma, "method": args.saliency_method,
        "cam_block": args.saliency_cam_block, "cam_upsample": args.saliency_cam_upsample,
        "tta_flip": args.saliency_tta_flip, "tta_shift": args.saliency_tta_shift,
    }
    device = resolve_device(args.device)
    mesh = None
    if args.num_devices is not None:
        from critic_vae_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.num_devices, device)
        if pri:
            print(f"sharding the device stage over {mesh.size} device(s)")
    episode_dir = args.episode or str(cfg.paths.resolve(cfg.paths.minerl_episode_path))
    frames, gt = load_episode(episode_dir, None if args.no_slice else cfg.mask.episode_slice)
    if len(frames) == 0:
        print("error: the episode slice selects 0 frames; try --no-slice", file=sys.stderr)
        return 1
    if gt is None and (args.sweep or searching):
        flag = "--sweep" if args.sweep else "--crf-search"
        print(f"error: {flag} needs IoU scoring, and the episode has no Y.npy",
              file=sys.stderr)
        return 1
    if not args.no_crf or searching:
        # resolve 'auto' (and check an explicit 'device') against the
        # episode's resolution and the device once, before any weights load
        from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

        try:
            backend = resolve_crf_backend(args.crf_backend, frames.shape[1], frames.shape[2],
                                          device=device)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if pri and args.crf_backend == "auto":
            print(f"crf backend: {backend} (auto)")
        args.crf_backend = backend
    critic = weights.critic_from_params(weights.load_critic(args.critic)).to(device)
    vae = weights.vae_from_params(*_load_vae(args, cfg)).to(device)
    if pri:
        print(f"processing {len(frames)} frames on {device}...")
        if gt is None:
            print("no Y.npy ground truth: IoU scoring and bin_info are skipped")
    source = dict(mask_source=args.mask_source, saliency_opts=saliency_opts, mesh=mesh)
    if args.sweep:
        if pri:
            print("testing thresholds (thr):")
        with profile_trace(args.profile):
            results = vid.threshold_sweep(
                vae, critic, frames, gt, thresholds, device=device, crf_params=crf_params,
                run_crf=not args.no_crf, batch_size=args.batch_size,
                compute_dtype=args.dtype, crf_backend=args.crf_backend, **source,
            )
        if pri:
            for r in results:
                print(f"thr={r['threshold']}, thr_iou={r['thr_iou']}, crf_iou={r['crf_iou']}")
        return 0
    from critic_vae_tpu_torch.viz.gif import pillow_available, write_gif

    # the same on every rank: the recons are gathered with the other outputs
    gif = not args.no_gif
    if gif and not pillow_available():
        if pri:
            print("Pillow is not installed: no GIF is written (as with --no-gif)")
        gif = False
    with profile_trace(args.profile):
        result = vid.eval_episode(
            vae, critic, frames, gt, device=device, threshold=args.threshold,
            crf_params=crf_params, run_crf=not args.no_crf and not searching,
            batch_size=args.batch_size, compute_dtype=args.dtype,
            crf_backend=args.crf_backend, recons_u8=True,
            with_recons=gif, **source,  # the recons feed the panels only
        )
    if searching:
        import dataclasses

        from critic_vae_tpu_torch.crf.device import crf_param_search
        from critic_vae_tpu_torch.ops.iou import iou

        if pri:
            print(f"searching CRF parameters "
                  f"({'default grid' if not args.crf_search else args.crf_search})...")
        best_masks, search = crf_param_search(frames, result.thr_masks, gt, search_grid,
                                              device=device, mesh=mesh)
        if pri:
            for score, p in search:
                print(f"  iou={score:.3f}  (w1={p[0]}, alpha={p[1]}, beta={p[2]}, "
                      f"w2={p[3]}, gamma={p[4]}, iters={p[5]})")
        result = dataclasses.replace(result, crf_masks=best_masks, crf_iou=iou(gt, best_masks))
    if gt is not None and pri:
        print(f"thr_iou={result.thr_iou}")
        print(f"crf_iou={result.crf_iou}")
        diag = vid.bin_diagnostics(result.preds, gt, result.thr_masks)
        vid.write_bin_info(diag, str(cfg.paths.resolve("bin_info_vae1.txt")),
                           total_frames=len(frames))
    if gif and pri:
        strips = vid.compose_frames(frames, result, gt, args.threshold)
        out = str(cfg.paths.resolve(
            os.path.join(cfg.paths.video_path, f"video-threshold={args.threshold}.gif")))
        print("creating video...")
        write_gif(strips, out)
        print(f"wrote {out}")
    return 0


def cmd_train(args) -> int:
    import time

    from critic_vae_tpu_torch.data.sampler import balanced_critic_sampler
    from critic_vae_tpu_torch.data.sources import open_source
    from critic_vae_tpu_torch.device import resolve_device
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines.train import save_final_weights, train

    device = resolve_device(args.device)
    cfg = _cfg(args)
    pri = _primary()  # every rank collects the same set and trains; only the primary writes
    critic = weights.critic_from_params(weights.load_critic(args.critic)).to(device)
    if pri:
        print(f"collecting balanced training frames from {args.source!r}...")
    dset = balanced_critic_sampler(
        open_source(args.source), critic, total_images=args.total_images, device=device,
        progress=(lambda n: print(f"total images = {n}", end="\r")) if pri else None)
    if pri:
        print(f"\ncollected {len(dset)} frames")
    pseudo_masks = None
    if args.mask_distill > 0.0:
        from critic_vae_tpu_torch.pipelines.distill import build_pseudo_masks

        if pri:
            print("building pseudo-label masks (LayerCAM + CAM-tuned CRF)...")
        pseudo_masks = build_pseudo_masks(critic, dset, device=device)
    log_dir = args.log_dir or str(cfg.paths.resolve(f"logs/vae{str(time.time())[-5:]}"))
    state = train(critic, dset, epochs=args.epochs, batch_size=args.batch_size,
                  learning_rate=args.lr, kld_weight=args.kld_weight,
                  faithful_msssim=not args.correct_msssim, compute_dtype=args.dtype,
                  seed=args.seed, value_consistency=args.value_consistency,
                  mask_distill=args.mask_distill, pseudo_masks=pseudo_masks, film=args.film,
                  shard_dataset=False if args.no_shard_dataset else "auto",
                  log_dir=log_dir, checkpoint_dir=str(cfg.paths.resolve("checkpoints")),
                  resume=not args.no_resume, log_images=args.log_images, device=device)
    if pri:  # the state is equal on every rank
        enc = str(cfg.paths.resolve(cfg.paths.encoder_path))
        dec = str(cfg.paths.resolve(cfg.paths.decoder_path))
        save_final_weights(state, enc, dec)
        print(f"saved {enc} and {dec}")
    return 0


def _final_vae(args, cfg: Config, second: bool = False):
    """(params, bn_state) from --encoder/--decoder, else the ``train``
    artifacts (with ``second``, the second VAE's) under ``--root``; a
    missing file raises, as in the JAX package."""
    from critic_vae_tpu_torch.io import weights

    paths = cfg.paths
    enc = args.encoder or str(paths.resolve(
        paths.second_encoder_path if second else paths.encoder_path))
    dec = args.decoder or str(paths.resolve(
        paths.second_decoder_path if second else paths.decoder_path))
    return weights.load_final_weights(enc, dec)


def _run_eval(args, second: bool, inject: bool) -> int:
    import numpy as np

    from critic_vae_tpu_torch.device import resolve_device
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines import evaluate as ev

    values = None
    if inject and args.values:
        values = np.asarray([float(v) for v in args.values.split(",")], np.float32)
    device = resolve_device(args.device)
    cfg = _cfg(args)
    pri = _primary()  # every rank computes, only the primary writes
    critic = weights.critic_from_params(weights.load_critic(args.critic)).to(device)
    vae = weights.vae_from_params(*_final_vae(args, cfg, second)).to(device)
    images, files = ev.load_image_dir(
        args.images or str(cfg.paths.resolve(cfg.paths.source_images_path)))
    if pri:
        print(f"evaluating {len(files)} source images...")
    if inject:
        out_dir = args.out or str(cfg.paths.resolve(cfg.paths.inject_path))
        res = ev.inject_images(vae, critic, images, values, device=device)
        paths = ev.save_inject_strips(res, images, out_dir) if pri else []
    else:
        out_dir = args.out or str(cfg.paths.resolve(cfg.paths.save_path))
        res = ev.evaluate_images(vae, critic, images, device=device)
        paths = ev.save_eval_strips(res, images, out_dir) if pri else []
    if pri:
        print(f"wrote {len(paths)} strips to {out_dir}")
    return 0


def cmd_dataset(args) -> int:
    from critic_vae_tpu_torch.data.sources import open_source
    from critic_vae_tpu_torch.device import resolve_device
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines.dataset import build_recon_dataset, save_dataset

    device = resolve_device(args.device)
    cfg = _cfg(args)
    critic = weights.critic_from_params(weights.load_critic(args.critic))
    vae = weights.vae_from_params(*_final_vae(args, cfg))
    dset = build_recon_dataset(open_source(args.source), critic, vae,
                               total_images=args.total_images, device=device)
    out = args.out or str(cfg.paths.resolve(cfg.paths.save_dataset_path))
    if _primary():  # one writer of the file
        save_dataset(out, dset)
        print(f"saved {len(dset)} recon frames to {out}")
    return 0


def cmd_second(args) -> int:
    from critic_vae_tpu_torch.device import resolve_device
    from critic_vae_tpu_torch.io import weights
    from critic_vae_tpu_torch.pipelines.dataset import load_dataset
    from critic_vae_tpu_torch.pipelines.train import save_final_weights, train

    device = resolve_device(args.device)
    cfg = _cfg(args)
    pri = _primary()  # every rank trains, only the primary writes
    critic = weights.critic_from_params(weights.load_critic(args.critic))
    path = args.dataset_path or str(cfg.paths.resolve(cfg.paths.save_dataset_path))
    if pri:
        print("training second vae...")
    state = train(critic, load_dataset(path), epochs=args.epochs, batch_size=args.batch_size,
                  learning_rate=args.lr, faithful_msssim=not args.correct_msssim,
                  seed=args.seed, log_dir=None, checkpoint_dir=None, resume=False,
                  device=device)
    if pri:
        enc = str(cfg.paths.resolve(cfg.paths.second_encoder_path))
        dec = str(cfg.paths.resolve(cfg.paths.second_decoder_path))
        save_final_weights(state, enc, dec)
        print(f"saved {enc} and {dec}")
    return 0


def _labelled_frames(args):
    """(frames, gt) of ``--episodes`` or synthetic frames; (None, None) after
    printing the JAX package's error when no episode has Y.npy."""
    import glob
    import os

    import numpy as np

    if not args.episodes:
        from critic_vae_tpu_torch.data.synthetic import generate_frames

        return generate_frames(args.synthetic_frames, seed=args.seed)
    from critic_vae_tpu_torch.data.episode import load_episode

    dirs = sorted(d for d in glob.glob(os.path.join(args.episodes, "*"))
                  if os.path.isfile(os.path.join(d, "X.npy")))
    if os.path.isfile(os.path.join(args.episodes, "X.npy")):
        dirs.insert(0, args.episodes)
    if not dirs:
        print(f"error: no episodes (X.npy/Y.npy) under {args.episodes}", file=sys.stderr)
        return None, None
    frames_list, gt_list = [], []
    for d in dirs:
        f, g = load_episode(d, episode_slice=None)
        if g is None:  # critic training needs labels
            print(f"skipping {d}: no Y.npy ground truth", file=sys.stderr)
            continue
        frames_list.append(f)
        gt_list.append(g)
    if not frames_list:
        print("error: no episode with Y.npy ground truth found — "
              "traincritic needs labeled frames", file=sys.stderr)
        return None, None
    return np.concatenate(frames_list), np.concatenate(gt_list)


def cmd_traincritic(args) -> int:
    import os

    from critic_vae_tpu_torch.device import resolve_device
    from critic_vae_tpu_torch.io.weights import save_critic
    from critic_vae_tpu_torch.train import critic as tc

    frames, gt = _labelled_frames(args)
    if frames is None:
        return 1
    device = resolve_device(args.device)
    pri = _primary()  # every rank trains the same critic, only the primary writes
    bin_labels = tc.labels_from_masks(gt)
    labels = tc.soft_trunk_labels(gt) if args.labels == "soft" else bin_labels
    if pri:
        print(f"training critic on {len(frames)} frames "
              f"({bin_labels.mean():.0%} positive, {args.labels} labels"
              + (f", best-of-{args.cam_select} by CAM health" if args.cam_select > 1 else "")
              + ")...")
    health = None
    if args.cam_select > 1:
        params, health, reports = tc.train_critic_selected(
            frames, labels, candidates=args.cam_select, base_seed=args.seed,
            epochs=args.epochs, batch_size=args.batch_size, learning_rate=args.lr,
            dropout_rate=args.dropout, health_target=args.cam_health_target, device=device)
        loss = next(r["final_loss"] for r in reports if r["seed"] == health["selected_seed"])
        if health.get("health_target_met") is False and pri:
            print(f"WARNING: no candidate reached --cam-health-target "
                  f"{args.cam_health_target} within {args.cam_select} seeds "
                  f"(best deletion_drop {health['deletion_drop']:.3f}); "
                  f"keeping the best — consider rerunning with a later "
                  f"--seed or a larger --cam-select")
    else:
        # as in the JAX package, --cam-health-target is not read here
        params, loss = tc.train_critic(frames, labels, epochs=args.epochs,
                                       batch_size=args.batch_size, learning_rate=args.lr,
                                       dropout_rate=args.dropout, seed=args.seed, device=device)
    acc = tc.critic_accuracy(params, frames, bin_labels, device=device)
    if health is None and not args.no_cam_health:
        health = tc.critic_cam_health(params, frames, device=device)
    if not pri:
        return 0
    out = args.out or str(_cfg(args).paths.resolve(CRITIC_OUT_PATH))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_critic(out, params)
    print(f"final loss={loss:.4f} train acc={acc:.3f}; saved {out}")
    if health is not None:
        print("cam health (no-GT, train/critic.py::critic_cam_health): "
              + " ".join(f"{k}={v:.4g}" for k, v in health.items()))
        if health["deletion_drop"] < tc.CAM_HEALTH_MIN_DELETION_DROP:
            print(
                f"WARNING: deletion_drop "
                f"{health['deletion_drop']:.3f} < "
                f"{tc.CAM_HEALTH_MIN_DELETION_DROP} — this critic's "
                f"LayerCAM localization looks DEGENERATE (accuracy "
                f"does not predict CAM quality; docs/RESULTS.md round "
                f"5). The saliency mask chain (`video --quality`, "
                f"mask distillation) will underperform with it; "
                f"retrain with --labels soft or another --seed.",
                file=sys.stderr,
            )
    return 0


def cmd_export(args) -> int:
    from critic_vae_tpu_torch.io import weights

    if not _primary():  # files only, no collective: the primary writes them
        return 0
    wrote = []
    if args.encoder_out or args.decoder_out:
        if not (args.encoder_out and args.decoder_out):
            print("error: --encoder-out and --decoder-out go together", file=sys.stderr)
            return 1
        enc_sd, dec_sd = weights.vae_state_dicts_to_torch(*_final_vae(args, _cfg(args)))
        weights.save_state_dict_pt(args.encoder_out, enc_sd)
        weights.save_state_dict_pt(args.decoder_out, dec_sd)
        wrote += [args.encoder_out, args.decoder_out]
    if args.critic_out:
        weights.save_state_dict_pt(args.critic_out, weights.critic_state_dict_to_torch(
            weights.load_critic(args.critic)))
        wrote.append(args.critic_out)
    if not wrote:
        print("error: nothing to export (pass --encoder-out/--decoder-out "
              "and/or --critic-out)", file=sys.stderr)
        return 1
    print(f"exported {', '.join(wrote)}")
    return 0


COMMANDS = {
    "video": cmd_video,
    "train": cmd_train,
    "eval": lambda args: _run_eval(args, second=False, inject=False),
    "inject": lambda args: _run_eval(args, second=False, inject=True),
    "evalsecond": lambda args: _run_eval(args, second=True, inject=False),
    "traincritic": cmd_traincritic,
    "dataset": cmd_dataset,
    "second": cmd_second,
    "export": cmd_export,
}


def main(argv: Optional[list] = None) -> int:
    import torch.distributed as dist

    from critic_vae_tpu_torch.parallel.distributed import init_distributed, world_size

    args = build_parser().parse_args(argv)
    # ranks: the process group comes first, before any device use
    # (parallel/distributed.py); a no-op without a launcher's environment
    formed = not dist.is_initialized()
    init_distributed(device=args.device)
    formed = formed and dist.is_initialized()
    if dist.is_initialized() and _primary():
        # the port prints this whenever a group exists, one rank included
        print(f"multi-host: {world_size()} processes, {world_size()} devices")
    try:
        return COMMANDS[args.command](args)
    finally:
        if formed:
            dist.destroy_process_group()
