"""``python -m torch.distributed.run --nproc-per-node 2 -m critic_vae_tpu_torch
video --device cpu --num-devices 2``: two gloo ranks launched as a user
launches them. Rank 0 alone prints (its own stdout file under the
launcher's ``--log-dir``) and writes bin_info; the IoUs and bin_info equal
one process's.

The ranks run chunks of 4 frames as rows of 2 each; the one-process run
takes chunks of 2, so that every conv sees the batches the ranks' do
(oneDNN's CPU convs choose their blocking by batch size, which moves a
float32 sum by an ulp): the chunks' frames, their padding and the mean of
the maxima are then the same.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch

from critic_vae_tpu_torch.cli import main
from critic_vae_tpu_torch.data.synthetic import generate_episode
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.parallel import distributed

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

REPO = Path(__file__).resolve().parent.parent


def test_torchrun_video_matches_one_process(tmp_path, capsys):
    ep, vae = tmp_path / "ep", tmp_path / "vae.npz"
    generate_episode(str(ep), num_frames=5, seed=6)
    weights.save_vae_npz(str(vae), *weights.numpy_vae_params(2, dims=(4, 8, 8, 16),
                                                            bottleneck=256))
    args = ["video", "--episode", str(ep), "--no-slice", "--vae", str(vae), "--device", "cpu",
            "--no-gif"]
    (tmp_path / "ranks").mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for var in (*distributed.COORDINATOR_VARS, *distributed.LAUNCHER_VARS,
                distributed.OPT_IN_VAR):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "--log-dir", str(tmp_path / "logs"), "--redirects", "3", "-m", "critic_vae_tpu_torch",
         *args, "--num-devices", "2", "--batch-size", "4", "--root", str(tmp_path / "ranks")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    stdout = {p.parent.name: p.read_text() for p in (tmp_path / "logs").rglob("stdout.log")}
    assert sorted(stdout) == ["0", "1"] and stdout["1"] == ""
    lines = stdout["0"].splitlines()
    assert lines[:3] == ["multi-host: 2 processes, 2 devices",
                         "sharding the device stage over 2 device(s)",
                         "crf backend: host (auto)"]
    ranks_ious = [ln for ln in lines if ln.startswith(("thr_iou=", "crf_iou="))]

    (tmp_path / "one").mkdir()
    assert main([*args, "--batch-size", "2", "--root", str(tmp_path / "one")]) == 0
    one = capsys.readouterr().out.splitlines()
    assert len(ranks_ious) == 2
    assert ranks_ious == [ln for ln in one if ln.startswith(("thr_iou=", "crf_iou="))]
    assert ((tmp_path / "ranks" / "bin_info_vae1.txt").read_bytes()
            == (tmp_path / "one" / "bin_info_vae1.txt").read_bytes())
