"""The port's command line against the JAX package's: every option of the
nine commands with its default (the deviations listed below), ``video``'s
defaults under ``--root`` (its episode and its weight artifacts), ``--seed``
on every command, and ``--profile``'s trace."""

import argparse
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu import cli as jcli
from critic_vae_tpu.pipelines.train import save_final_weights
from critic_vae_tpu_torch import cli as tcli
from critic_vae_tpu_torch.data.synthetic import generate_episode
from critic_vae_tpu_torch.io import weights

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

ROOT = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
COMMANDS = ("train", "eval", "inject", "evalsecond", "video", "dataset", "second",
            "traincritic", "export")
# The port's own options, which the JAX package lacks: the device of a run
# (every command), and video's combined VAE file and random VAE weights.
PORT_ONLY = {"--device", "--vae", "--vae-seed"}
# Options whose default is not the JAX package's: --critic's default is the
# repo's synthetic critic, as the JAX package's (the reference's critic under
# --root) is not in the repo (ROADMAP C.10). video's --num-devices is
# accepted with JAX's default; a count other than the ranks' raises
# (tests/test_torch_parallel.py).
OTHER_DEFAULT = {"--critic": str(tcli.DEFAULT_CRITIC)}


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(sub):
    return {s: a for a in sub._actions for s in a.option_strings if s.startswith("--")
            and s != "--help"}


@pytest.mark.parametrize("command", COMMANDS)
def test_every_jax_option_is_accepted_with_its_default(command):
    jsub = _subparsers(jcli.build_parser())[command]
    tsub = _subparsers(tcli.build_parser())[command]
    jopts, topts = _options(jsub), _options(tsub)
    assert set(jopts) <= set(topts), sorted(set(jopts) - set(topts))
    assert set(topts) - set(jopts) <= PORT_ONLY, sorted(set(topts) - set(jopts))
    for opt, ja in jopts.items():
        ta = topts[opt]
        assert ta.dest == ja.dest, opt
        assert ta.default == OTHER_DEFAULT.get(opt, ja.default), opt
        assert type(ta).__name__ == type(ja).__name__, opt  # store, store_true, ...
        assert ta.type == ja.type and ta.choices == ja.choices and ta.nargs == ja.nargs, opt
        assert ta.const == ja.const, opt


@pytest.mark.parametrize("command", COMMANDS)
def test_seed_and_profile_parse_on_every_command(command):
    """C.9: ``--seed`` (and ``--profile``) on all nine commands; argparse
    exited 2 on them in six before."""
    args = tcli.build_parser().parse_args([command, "--seed", "5", "--profile", "trace"])
    assert args.seed == 5 and args.profile == "trace"
    want = jcli.build_parser().parse_args([command, "--seed", "5", "--profile", "trace"])
    assert (want.seed, want.profile) == (args.seed, args.profile)


def test_help_names_the_deviation():
    assert "critic-synthetic.npz" in tcli.__doc__ and "PathConfig.critic_path" in tcli.__doc__
    video = _subparsers(tcli.build_parser())["video"]
    assert "--num-devices" in video.format_help()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A --root with minerl-episode/ (4 frames with Y.npy) and the JAX
    package's train artifacts under saved-networks/, full width."""
    r = tmp_path_factory.mktemp("root")
    generate_episode(str(r / "minerl-episode"), num_frames=4, seed=3)
    (r / "saved-networks").mkdir()
    params, state = weights.numpy_vae_params(4)
    save_final_weights(types.SimpleNamespace(params=params, bn_state=state),
                       str(r / "saved-networks" / "vae_encoder.ckpt"),
                       str(r / "saved-networks" / "vae_decoder.ckpt"))
    return r


def _video(capsys, *argv):
    rc = tcli.main(["video", "--no-slice", "--device", "cpu", "--crf-backend", "host",
                    "--no-gif", "--batch-size", "2", *argv])
    out = capsys.readouterr().out.splitlines()
    return rc, [ln for ln in out if ln.startswith(("thr_iou=", "crf_iou="))]


def test_video_reads_the_episode_and_artifacts_under_root(root, tmp_path, capsys):
    """C.8: without --episode and --encoder/--decoder, ``video`` reads
    --root/minerl-episode and --root/saved-networks/vae_{encoder,decoder}.ckpt,
    as the JAX package's, and prints what the explicit flags print."""
    rc, by_root = _video(capsys, "--root", str(root))
    assert rc == 0 and len(by_root) == 2, by_root
    other = tmp_path / "other"
    other.mkdir()
    nets = root / "saved-networks"
    rc, explicit = _video(capsys, "--root", str(other), "--episode", str(root / "minerl-episode"),
                          "--encoder", str(nets / "vae_encoder.ckpt"),
                          "--decoder", str(nets / "vae_decoder.ckpt"))
    assert rc == 0 and by_root == explicit
    assert (root / "bin_info_vae1.txt").read_bytes() == (other / "bin_info_vae1.txt").read_bytes()


@pytest.mark.parametrize("missing", ["artifacts", "episode"])
def test_video_without_its_files_raises_as_jax(root, tmp_path, missing):
    """C.8: a --root without the artifacts (or without the episode) raises
    FileNotFoundError in both packages (``python -m`` exits 1), where the port
    once ran random weights."""
    bare = tmp_path / "bare"
    bare.mkdir()
    if missing == "artifacts":
        generate_episode(str(bare / "minerl-episode"), num_frames=2, seed=0)
    else:
        (bare / "saved-networks").symlink_to(root / "saved-networks")
    argv = ["video", "--root", str(bare), "--critic", CRITIC_NPZ, "--no-slice", "--no-gif",
            "--no-crf"]
    with pytest.raises(FileNotFoundError):
        jcli.cmd_video(jcli.build_parser().parse_args(argv))
    with pytest.raises(FileNotFoundError):
        tcli.main([*argv, "--device", "cpu"])


def test_vae_seed_is_the_ports_explicit_option(root, capsys):
    args = tcli.build_parser().parse_args(["video"])
    assert args.vae_seed is None and args.episode is None
    rc = tcli.main(["video", "--root", str(root), "--no-slice", "--device", "cpu", "--no-gif",
                    "--no-crf", "--vae-seed", "0", "--batch-size", "2"])
    assert rc == 0 and "thr_iou=" in capsys.readouterr().out


def _traces(d: Path):
    return sorted(d.rglob("*.pt.trace.json"))


def test_video_profile_writes_a_trace(tmp_path, capsys):
    ep = tmp_path / "ep"
    generate_episode(str(ep), num_frames=3, seed=1)
    vae = tmp_path / "vae.npz"
    weights.save_vae_npz(str(vae), *weights.numpy_vae_params(1, dims=(4, 8, 8, 16),
                                                            bottleneck=256))
    argv = ["video", "--episode", str(ep), "--no-slice", "--vae", str(vae), "--device", "cpu",
            "--no-crf", "--no-gif", "--root", str(tmp_path)]
    assert tcli.main(argv) == 0
    assert _traces(tmp_path) == []
    trace_dir = tmp_path / "trace"
    assert tcli.main([*argv, "--profile", str(trace_dir)]) == 0
    found = _traces(trace_dir)
    assert len(found) == 1 and found[0].stat().st_size > 0
    text = found[0].read_text()
    assert "aten::" in text and "traceEvents" in text
    assert '"video.episode"' in text and '"video.device_stage"' in text
    assert tcli.main([*argv, "--sweep-range", "40:50", "--profile", str(trace_dir)]) == 0
    assert len(_traces(trace_dir)) == 2
    out = capsys.readouterr().out
    assert out.count("thr_iou=") == 4  # two episode runs, two thresholds of the sweep


def test_profiling_helpers(tmp_path):
    from critic_vae_tpu_torch.utils.profiling import device_barrier, profile_trace, span

    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "trace")), span("unit.block"):
        torch.zeros(2).add_(1)
    found = _traces(tmp_path / "trace")
    assert len(found) == 1 and '"unit.block"' in found[0].read_text()
    assert device_barrier(torch.zeros(2)) is None
    assert device_barrier(np.zeros(2)) is None
