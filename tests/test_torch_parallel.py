"""The port's multi-process layer (critic_vae_tpu_torch/parallel/) and the
meshed serving path: ``init_distributed``'s detection, ``make_mesh``'s
errors, ``fetch``, and two gloo ranks on the CPU running ``eval_episode``
(the diff source with the device CRF's ``xla`` build, the SmoothGrad
source), ``threshold_sweep``'s device path, ``refine_masks_device``,
``crf_param_search``, ``train``/``dataset``/``second`` and the command
line's rank guards, against one process and against the JAX package's
meshed ``eval_episode``.

The two ranks split each chunk of 4 frames into rows of 2. oneDNN's CPU
convs choose their blocking by batch size, which moves a float32 sum by
an ulp, so both the ranks and the one-process reference run PyTorch's own
convs (``torch.backends.mkldnn.enabled = False``), whose per-frame
arithmetic does not depend on the batch: then the meshed results equal the
one process's bitwise (preds within 1e-5). Against the JAX package the
ROADMAP's bars hold: preds within 1e-5, maps >= 99.9% within one level,
threshold masks >= 99.8%, CRF masks >= 99.9%, thr_iou equal, crf_iou
within 1e-3.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.cli import main
from critic_vae_tpu_torch.crf.device import crf_param_search, refine_masks_device
from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.parallel import distributed, mesh as pmesh
from critic_vae_tpu_torch.pipelines.video import eval_episode, threshold_sweep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

REPO = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(REPO / "saved-networks" / "critic-synthetic.npz")
CPU = torch.device("cpu")
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
SMOOTHGRAD = {"logits": True, "samples": 2, "noise": 0.1, "seed": 3}
ENV_VARS = (*distributed.COORDINATOR_VARS, *distributed.LAUNCHER_VARS, distributed.OPT_IN_VAR)


def _models():
    return (weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ)),
            weights.vae_from_params(*weights.numpy_vae_params(2, **NARROW)))


def _cases(mesh):
    """Every meshed case at 9 frames (no batch divides them): a dict of numpy
    arrays, from ``mesh`` (None: one process)."""
    critic, vae = _models()
    frames, gt = generate_frames(9, seed=5)
    out = {}
    r = eval_episode(vae, critic, frames, gt, device=CPU, crf_backend="device", batch_size=4,
                     with_recons=True, recons_u8=True, mesh=mesh)
    out.update(preds=r.preds, diff_u8=r.diff_u8, thr=r.thr_masks, crf=r.crf_masks,
               recon_one=r.recon_one, recon_zero=r.recon_zero,
               ious=np.array([r.thr_iou, r.crf_iou]))
    s = eval_episode(vae, critic, frames, gt, device=CPU, run_crf=False, batch_size=4,
                     mask_source="saliency", saliency_opts=SMOOTHGRAD, mesh=mesh)
    out.update(sg_preds=s.preds, sg_diff_u8=s.diff_u8, sg_thr=s.thr_masks)
    sweep = threshold_sweep(vae, critic, frames[:3], gt[:3], device=CPU, crf_backend="device",
                            batch_size=2, mesh=mesh)
    out["sweep"] = np.array([[d["threshold"], d["thr_iou"], d["crf_iou"]] for d in sweep])
    # the device CRF alone on 7 ragged 20x20 crops: chunks of 4, the last padded
    small = np.ascontiguousarray(frames[:7, :20, :20])
    masks = np.ascontiguousarray(gt[:7, :20, :20])
    out["refined"] = refine_masks_device(small, masks, device=CPU, frame_chunk=4, mesh=mesh)
    best, results = crf_param_search(small, masks, gt[1:8, :20, :20], {"w1": [11.0, 44.0]},
                                     device=CPU, mesh=mesh)
    out["search_best"] = best
    out["search"] = np.array([[score, *params] for score, params in results])
    return out


def _command(argv):
    """(exit code, stdout, stderr) of the port's ``main`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def rank_main(rank: int, outdir: str, address: str) -> None:
    """One of the two ranks: the collectives, the cases, the commands."""
    torch.backends.mkldnn.enabled = False
    assert distributed.init_distributed(address, num_processes=2, process_id=rank, device="cpu")
    assert distributed.world_size() == 2 and distributed.is_primary() == (rank == 0)
    mesh = pmesh.make_mesh(2, "cpu")
    assert (mesh.rank, mesh.size) == (rank, 2)
    x = torch.arange(6, dtype=torch.uint8).view(3, 2) + 10 * rank
    got = pmesh.fetch(mesh, x)
    assert got.dtype == torch.uint8 and torch.equal(got[3:] - got[:3], torch.full((3, 2), 10,
                                                                                  dtype=torch.uint8))
    for dt in (torch.float32, torch.bool, torch.bfloat16):
        y = ((rank + 1) * torch.arange(4.0)).to(dt)
        want = torch.cat([torch.arange(4.0), 2 * torch.arange(4.0)]).to(dt)
        assert torch.equal(pmesh.fetch(mesh, y), want), dt
    assert torch.equal(pmesh.shard_batch(mesh, torch.arange(6)), torch.arange(3) + 3 * rank)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **_cases(mesh))
    logs = {}
    # train, then the second VAE on its reconstructions, data-parallel at full
    # width on 15 frames (synthetic:1:16 collects 15; 17 reconstructions):
    # neither divides over the ranks, so both replicate their dataset
    train_root = os.path.join(outdir, "train")
    for command, args in (("train", ["--source", "synthetic:1:16", "--epochs", "1",
                                     "--batch-size", "4"]),
                          ("dataset", ["--source", "synthetic:1:16"]),
                          ("second", ["--epochs", "1", "--batch-size", "4"])):
        logs[command] = _command([command, *args, "--device", "cpu", "--root", train_root])
        torch.distributed.barrier()  # the primary's files exist before the next command
    ep = os.path.join(outdir, "ep")
    if rank == 0:
        generate_episode(ep, num_frames=4, seed=6)
        weights.save_vae_npz(os.path.join(outdir, "vae.npz"),
                             *weights.numpy_vae_params(2, **NARROW))
    torch.distributed.barrier()
    root = os.path.join(outdir, f"root{rank}")
    os.makedirs(root)
    logs["video"] = _command(["video", "--episode", ep, "--no-slice", "--vae",
                              os.path.join(outdir, "vae.npz"), "--device", "cpu",
                              "--num-devices", "0", "--batch-size", "2", "--no-gif",
                              "--root", root])
    with open(os.path.join(outdir, f"logs{rank}.json"), "w") as f:
        json.dump(logs, f)
    torch.distributed.destroy_process_group()
    sys.stdout.write(f"RANK_OK {rank}\n")
    sys.stdout.flush()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks (one spawn of two processes) and, meanwhile, the
    one-process reference of the same cases in this process: (reference,
    [rank 0's arrays, rank 1's], [rank 0's command log, rank 1's], outdir)."""
    outdir = tmp_path_factory.mktemp("ranks")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "from tests.test_torch_parallel import rank_main; "
            "rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ENV_VARS:
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i), str(outdir),
                               f"127.0.0.1:{port}"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
             for i in range(2)]
    try:
        mkldnn = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            reference = _cases(None)
        finally:
            torch.backends.mkldnn.enabled = mkldnn
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {i}" in out, f"rank {i}:\n{out[-4000:]}"
    got = [dict(np.load(outdir / f"rank{i}.npz")) for i in range(2)]
    logs = [json.loads((outdir / f"logs{i}.json").read_text()) for i in range(2)]
    return reference, got, logs, outdir


def test_init_distributed_is_a_noop_without_an_environment(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary() and distributed.world_size() == 1


def test_a_coordinator_needs_the_ranks(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_one_process_mesh():
    for n in (0, 1):
        m = pmesh.make_mesh(n, "cpu")
        assert (m.rank, m.size, m.group, m.device) == (0, 1, None, CPU)
    x = torch.arange(5)
    assert pmesh.fetch(m, x) is x and torch.equal(pmesh.shard_batch(m, x), x)
    assert pmesh.replicate(m, {"w": x})["w"] is x and pmesh.row_offset(m, 5) == 0


def test_make_mesh_raises_jaxs_error():
    with pytest.raises(ValueError, match=r"requested a 3-device mesh but only 1 rank\(s\)"
                                         r".*torch\.distributed\.run --nproc-per-node 3"):
        pmesh.make_mesh(3, "cpu")


def test_auto_crf_takes_the_host_on_more_than_one_rank(monkeypatch):
    """As the JAX package's policy: ``auto`` gives the device CRF to a
    one-process run only."""
    from critic_vae_tpu_torch.crf import policy

    assert policy.resolve_crf_backend("auto", 64, 64, device="cuda") == "device"
    monkeypatch.setattr(policy, "world_size", lambda: 2)
    assert policy.resolve_crf_backend("auto", 64, 64, device="cuda") == "host"
    assert policy.resolve_crf_backend("device", 64, 64, device="cuda") == "device"


def test_video_num_devices_in_one_process(tmp_path, capsys):
    """``--num-devices 1`` (and 0) in one process is a one-rank mesh with the
    unmeshed results; 2 raises make_mesh's error."""
    generate_episode(str(tmp_path / "ep"), num_frames=3, seed=4)
    weights.save_vae_npz(str(tmp_path / "vae.npz"), *weights.numpy_vae_params(2, **NARROW))
    argv = ["video", "--episode", str(tmp_path / "ep"), "--no-slice", "--vae",
            str(tmp_path / "vae.npz"), "--device", "cpu", "--no-gif", "--root", str(tmp_path)]
    assert main(argv) == 0
    plain = capsys.readouterr().out.splitlines()
    for n in ("1", "0"):
        assert main([*argv, "--num-devices", n]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert "sharding the device stage over 1 device(s)" in lines
        assert [ln for ln in lines if "iou=" in ln] == [ln for ln in plain if "iou=" in ln]
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        main([*argv, "--num-devices", "2"])


def test_meshed_eval_episode_equals_one_process(ranks):
    reference, got, _, _ = ranks
    for g in got:  # both ranks hold the whole result
        assert np.abs(g["preds"] - reference["preds"]).max() <= 1e-5
        for key in ("diff_u8", "thr", "crf", "recon_one", "recon_zero", "ious"):
            assert g[key].dtype == reference[key].dtype, key
            np.testing.assert_array_equal(g[key], reference[key], err_msg=key)


def test_meshed_smoothgrad_equals_one_process(ranks):
    """Each rank draws its chunk's whole SmoothGrad noise and takes its rows'."""
    reference, got, _, _ = ranks
    for g in got:
        assert np.abs(g["sg_preds"] - reference["sg_preds"]).max() <= 1e-5
        np.testing.assert_array_equal(g["sg_diff_u8"], reference["sg_diff_u8"])
        np.testing.assert_array_equal(g["sg_thr"], reference["sg_thr"])


def test_meshed_sweep_equals_one_process(ranks):
    reference, got, _, _ = ranks
    for g in got:
        np.testing.assert_array_equal(g["sweep"], reference["sweep"])


def test_meshed_crf_and_search_equal_one_process(ranks):
    reference, got, _, _ = ranks
    assert reference["search"].shape == (2, 7)
    for g in got:
        for key in ("refined", "search_best", "search"):
            np.testing.assert_array_equal(g[key], reference[key], err_msg=key)


def test_meshed_eval_episode_matches_jax_meshed(ranks):
    """The port's two ranks against the JAX package's eval_episode over a
    2-device mesh (tests/conftest.py's virtual CPU devices) at the ROADMAP's
    bars."""
    from critic_vae_tpu.parallel.mesh import make_mesh
    from critic_vae_tpu.pipelines.video import eval_episode as jax_eval_episode

    _, got, _, _ = ranks
    frames, gt = generate_frames(9, seed=5)
    want = jax_eval_episode(*weights.numpy_vae_params(2, **NARROW),
                            weights.load_critic_npz(CRITIC_NPZ), frames, gt,
                            crf_backend="device", with_recons=False, batch_size=4,
                            mesh=make_mesh(2))
    g = got[0]
    assert np.abs(g["preds"] - want.preds).max() <= 1e-5
    assert np.mean(np.abs(g["diff_u8"].astype(int) - want.diff_u8.astype(int)) <= 1) >= 0.999
    assert np.mean(g["thr"] == want.thr_masks) >= 0.998
    assert np.mean(g["crf"] == want.crf_masks) >= 0.999
    assert g["ious"][0] == want.thr_iou and abs(g["ious"][1] - want.crf_iou) <= 1e-3


@pytest.mark.parametrize("command", ["train", "second"])
def test_training_runs_on_two_ranks(ranks, command):
    """``train`` (then ``dataset``) and ``second`` on two ranks: exit 0 on
    both, the primary alone prints and writes, and the artifacts load in
    the JAX package's ``load_final_weights``."""
    from critic_vae_tpu.pipelines.train import load_final_weights

    _, _, logs, outdir = ranks
    root = outdir / "train"
    for log in logs:
        assert log[command][0] == 0 and log["dataset"][0] == 0
    out0 = logs[0][command][1].replace("\r", "\n").splitlines()
    assert out0[0] == "multi-host: 2 processes, 2 devices"
    assert logs[1][command][1] == "" and logs[1]["dataset"][1] == ""
    replicating = [ln for ln in out0 if ln.startswith("dataset not shardable over 2 devices")]
    assert replicating and replicating[0].endswith("; replicating")
    if command == "train":
        nets = root / "saved-networks"
        enc, dec = nets / "vae_encoder.ckpt", nets / "vae_decoder.ckpt"
        assert "collected 15 frames" in out0
        assert sorted(os.listdir(root / "checkpoints")) == ["ckpt-3.meta.json", "ckpt-3.npz"]
        (log_dir,) = (root / "logs").iterdir()  # one writer: one events file and one JSONL
        assert sorted(p.name.split(".")[0] for p in log_dir.iterdir()) == ["events", "metrics"]
        assert (root / "recon-dataset.npz").is_file()
    else:
        enc, dec = root / "vae2_encoder.ckpt", root / "vae2_decoder.ckpt"
        assert "training second vae..." in out0
    assert out0[-1] == f"saved {enc} and {dec}"
    like = weights.numpy_vae_params(0)
    params, bn_state = load_final_weights(str(enc), str(dec), *like)
    assert params["decoder"]["conv4"]["w"].shape == (5, 5, 32, 3)
    assert all(np.isfinite(np.asarray(v)).all() for v in bn_state["bn0"].values())


def test_only_the_primary_writes(ranks):
    _, _, logs, outdir = ranks
    (rc0, out0, _), (rc1, out1, _) = logs[0]["video"], logs[1]["video"]
    assert rc0 == rc1 == 0
    assert out0.splitlines()[:3] == ["multi-host: 2 processes, 2 devices",
                                     "sharding the device stage over 2 device(s)",
                                     "crf backend: host (auto)"]  # auto: more than one process
    assert sum(ln.startswith(("thr_iou=", "crf_iou=")) for ln in out0.splitlines()) == 2
    assert out1 == ""
    assert (outdir / "root0" / "bin_info_vae1.txt").is_file()
    assert list((outdir / "root1").iterdir()) == []
