"""The port's data-parallel VAE training (critic_vae_tpu_torch: the
reductions of parallel/mesh.py, train-mode BatchNorm and the losses over a
mesh, train/step.py's ``make_multi_step(mesh=)``,
``make_sharded_multi_step`` and ``sharded_epoch_indices``, and
pipelines/train.py's ``train(shard_dataset=...)``) on two
gloo ranks on the CPU, against the JAX package and against one process.

One spawn of two ranks runs every multi-rank case; the JAX runs and the
one-process references run in this process meanwhile. The setup is
tests/test_torch_train.py's: VAE dims (4, 8, 8, 16), the full-width critic
of critic-synthetic.npz, 12 frames, batch 4 (2 rows a rank), 3 steps given
JAX's draws. Both ranks run PyTorch's own convs (oneDNN off: its blocking
follows the batch size). Tolerances, float32:

* losses within 1e-5 relative (JAX's, and one process's);
* against JAX, test_torch_train.py's state bars: BN running variances 1e-5
  relative, means 1.5·lr; parameters 0.25·lr, the encoder's conv biases
  (train-mode BatchNorm cancels them, so their gradient is float noise)
  2·lr a step;
* Adam's first moment after step 1 (0.1 times the gradient) within 1e-5
  relative a leaf (the norm of the error over the leaf's), the encoder's
  conv biases excepted (one process reads up to 6.7e-6): a step
  that averaged per-rank gradients over per-rank BatchNorm and MS-SSIM (a
  plain DDP port) misses this by orders of magnitude, and Adam's
  normalised update would hide it from the parameter bars;
* the two ranks' states bitwise equal; a resumed run bitwise the
  uninterrupted one.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from critic_vae_tpu.models.critic import load_critic as jax_load_critic
from critic_vae_tpu.train import step as jstep
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import checkpoint as tckpt
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.parallel import distributed, mesh as pmesh
from critic_vae_tpu_torch.pipelines import train as ttrain
from critic_vae_tpu_torch.train import step as tstep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

REPO = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(REPO / "saved-networks" / "critic-synthetic.npz")
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
LR = 5e-5
FRAMES, BATCH, RANKS = 12, 4, 2
SHARD = FRAMES // RANKS
LOSS_REL = 1e-5
BN_VAR_REL = 1e-5
BN_MEAN_ABS = 1.5 * LR
PARAM_TOL = 0.25 * LR
MU_REL = 1e-5
ENC_CONV_BIASES = {f"encoder/conv{i}/b" for i in range(4)}
TRAIN_KW = dict(epochs=2, batch_size=BATCH, learning_rate=LR, seed=0, log_every_batches=1,
                checkpoint_every_steps=2, device="cpu")
ENV_VARS = (*distributed.COORDINATOR_VARS, *distributed.LAUNCHER_VARS, distributed.OPT_IN_VAR)


def _tx():
    return optax.apply_if_finite(optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8),
                                 max_consecutive_errors=100)


def _narrow():
    return weights.numpy_vae_params(3, **NARROW)


def _dataset():
    return generate_frames(FRAMES, seed=1)[0]


def _critic():
    return weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))


def _inputs():
    """The step cases' indices: the replicated loop's global (3, 4) rows
    (test_torch_train.py's) and the sharded loop's local offsets."""
    idx = np.random.default_rng(0).permutation(FRAMES).reshape(3, BATCH).astype(np.int32)
    return idx, tstep.sharded_epoch_indices(np.random.default_rng(0), FRAMES, BATCH, RANKS)


def _jax_eps(key, steps, batch):
    """The noise ``_step_logic`` draws from a state's key, step by step."""
    out = []
    for _ in range(steps):
        key, sample_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sample_key, (batch, 32), jnp.float32)))
    return np.stack(out)


def _flat(state):
    return tckpt.flatten(tstep.state_tree(state))


# ------------------------------------------------------------------ the ranks


def _train_logged(critic, data, **kw):
    """(state, stdout) of ``ttrain.train``; stdout's carriage returns as
    line ends."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = ttrain.train(critic, data, **{**TRAIN_KW, "initial_params": _narrow(), **kw})
    return state, out.getvalue().replace("\r", "\n")


def rank_main(rank: int, outdir: str, address: str) -> None:
    """One of the two ranks: every case, its arrays into ``rank{r}.npz`` and
    its printed lines into ``logs{r}.json``."""
    torch.backends.mkldnn.enabled = False
    assert distributed.init_distributed(address, num_processes=2, process_id=rank, device="cpu")
    mesh = pmesh.make_mesh(0, "cpu")
    assert (mesh.rank, mesh.size) == (rank, RANKS)
    out, logs = {}, {}
    critic = _critic()
    data = torch.from_numpy(_dataset())
    idx, local = (torch.from_numpy(a) for a in _inputs())
    eps = torch.from_numpy(np.load(os.path.join(outdir, "eps.npz"))["eps"])

    # the replicated loop, step 1 alone (Adam's first moment), then 2 more
    state = tstep.init_train_state(*_narrow(), device="cpu")
    multi = tstep.make_multi_step(critic, mesh=mesh, learning_rate=LR)
    first = multi(state, data, idx[:1], eps[:1])
    out.update({f"mu1/{k}": v for k, v in _flat(state).items() if k.startswith("opt/mu/")})
    rest = multi(state, data, idx[1:], eps[1:])
    out.update({f"repl/loss/{k}": torch.cat([first[k], rest[k]]).numpy() for k in first})
    out.update({f"repl/{k}": v for k, v in _flat(state).items()})

    # the sharded loop on this rank's rows alone
    state = tstep.init_train_state(*_narrow(), device="cpu")
    sharded = tstep.make_sharded_multi_step(critic, mesh=mesh, learning_rate=LR)
    losses = sharded(state, data[pmesh.row_slice(mesh, FRAMES)].clone(), local, eps)
    out.update({f"shard/loss/{k}": v.numpy() for k, v in losses.items()})
    out.update({f"shard/{k}": v for k, v in _flat(state).items()})

    # a NaN frame in rank 1's rows of the first batch: both ranks skip
    state = tstep.init_train_state(*_narrow(), device="cpu")
    before = _flat(state)
    nan_data = data.float() / 255.0
    nan_data[idx[0, BATCH - 1]] = float("nan")
    multi(state, nan_data, idx[:1], eps[:1])
    after = _flat(state)
    out["nan/counters"] = np.array([int(state.notfinite_count), bool(state.last_finite),
                                    int(state.total_notfinite), int(state.step)])
    out["nan/unchanged"] = np.array(all(
        np.array_equal(before[k], after[k]) for k in before
        if k.startswith(("params/", "bn_state/", "opt/mu/", "opt/nu/"))))

    # train(): one writer of checkpoints, recorded where it writes
    save = tckpt.save_pytree

    def recording_save(path, tree):
        with open(os.path.join(outdir, "writers.txt"), "a") as f:
            f.write(f"{rank}\n")
        return save(path, tree)

    tckpt.save_pytree = recording_save
    frames = _dataset()
    barrier = torch.distributed.barrier
    runs = {"repl": dict(shard_dataset=False), "shard": dict(shard_dataset="auto")}
    for name, kw in runs.items():
        state, logs[name] = _train_logged(critic, frames, log_dir=os.path.join(outdir, name),
                                          checkpoint_dir=os.path.join(outdir, f"{name}_ckpt"),
                                          **kw)
        out.update({f"train_{name}/{k}": v for k, v in _flat(state).items()})
        barrier()
    # resume mid-epoch, sharded: stop after epoch 0 (checkpoints at steps 2
    # and 3), drop step 3's, resume from row 2 and finish
    resumed_dir = os.path.join(outdir, "resumed_ckpt")
    _train_logged(critic, frames, checkpoint_dir=resumed_dir, epochs=1)
    barrier()
    if rank == 0:
        for name in ("ckpt-3.npz", "ckpt-3.meta.json"):
            os.unlink(os.path.join(resumed_dir, name))
    barrier()
    state, logs["resumed"] = _train_logged(critic, frames, checkpoint_dir=resumed_dir)
    out.update({f"resumed/{k}": v for k, v in _flat(state).items()})
    barrier()
    try:  # the layout is part of the run: a replicated resume is refused
        _train_logged(critic, frames, checkpoint_dir=resumed_dir, shard_dataset=False)
        logs["refused"] = ""
    except ValueError as e:
        logs["refused"] = str(e)
    barrier()
    try:  # forced sharding of a layout the ranks do not divide
        _train_logged(critic, frames[:11], shard_dataset=True)
        logs["forced"] = ""
    except ValueError as e:
        logs["forced"] = str(e)
    # a checkpoint written before sharded training (no shard_dataset in its
    # meta) resumes as replicated
    old_dir = os.path.join(outdir, "repl_ckpt")
    if rank == 0:
        for name in os.listdir(old_dir):
            if name.endswith(".meta.json"):
                path = os.path.join(old_dir, name)
                with open(path) as f:
                    meta = json.load(f)
                del meta["shard_dataset"]
                with open(path, "w") as f:
                    json.dump(meta, f)
    barrier()
    state, logs["old_meta"] = _train_logged(critic, frames, checkpoint_dir=old_dir, epochs=3,
                                            shard_dataset=False)
    out["old_meta/step"] = np.array(int(state.step))
    barrier()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"logs{rank}.json"), "w") as f:
        json.dump(logs, f)
    torch.distributed.destroy_process_group()
    sys.stdout.write(f"RANK_OK {rank}\n")
    sys.stdout.flush()


def _jax_runs(critic):
    """JAX's multi-step loops from the narrow state with key 7: ``make_multi_step``
    over the global rows (step 1 alone, then 2 more) and
    ``make_sharded_multi_step`` over a 2-device mesh (tests/conftest.py's
    virtual CPU devices) on the local offsets."""
    from jax.sharding import PartitionSpec as P

    from critic_vae_tpu.parallel.mesh import device_put_global, make_mesh, replicate

    params, bn_state = _narrow()

    def state0():
        p = jax.tree.map(jnp.asarray, params)
        return jstep.TrainState(p, jax.tree.map(jnp.asarray, bn_state), _tx().init(p),
                                jax.random.key(7), jnp.zeros((), jnp.int32))

    idx, local = _inputs()
    data = _dataset()
    multi = jstep.make_multi_step(critic, _tx(), compute_dtype=jnp.float32, donate=False)
    s1, m1 = multi(state0(), jnp.asarray(data), jnp.asarray(idx[:1]))
    mu1 = s1.opt_state.inner_state[0].mu
    s3, m23 = multi(s1, jnp.asarray(data), jnp.asarray(idx[1:]))
    mesh = make_mesh(2)
    sharded = jstep.make_sharded_multi_step(replicate(mesh, critic), _tx(), mesh=mesh,
                                            donate=False)
    sh, msh = sharded(replicate(mesh, state0()),
                      device_put_global(mesh, data, P("data", None, None, None)),
                      device_put_global(mesh, local, P(None, "data")))
    return {"mu1": jax.device_get(mu1),
            "repl": (jax.device_get(s3),
                     {k: np.concatenate([np.asarray(m1[k]), np.asarray(m23[k])]) for k in m1}),
            "shard": (jax.device_get(sh), {k: np.asarray(v) for k, v in msh.items()})}


def _one_process(tmp):
    """The same train() runs in one process (no group: no mesh): the
    replicated layout's metrics.jsonl, and the sharded layout's per-step
    losses as make_multi_step over the equivalent global rows of JAX's
    sharded shuffle."""
    critic = _critic()
    frames = _dataset()
    ttrain.train(critic, frames, initial_params=_narrow(), log_dir=str(tmp / "one"),
                 progress=False, **TRAIN_KW)
    state = tstep.init_train_state(*_narrow(), device="cpu", seed=0)
    multi = tstep.make_multi_step(critic, learning_rate=LR)
    rng = np.random.default_rng(0)
    owner = np.repeat(np.arange(RANKS) * SHARD, BATCH // RANKS)[None, :]
    losses = []
    for _ in range(TRAIN_KW["epochs"]):
        rows = jstep.sharded_epoch_indices(rng, FRAMES, BATCH, RANKS) + owner
        losses.append(multi(state, torch.from_numpy(frames),
                            torch.from_numpy(rows.astype(np.int32)))["total_loss"].numpy())
    return {"repl": _jsonl(tmp / "one"), "shard": np.concatenate(losses)}


def _jsonl(log_dir):
    with open(Path(log_dir) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return np.array([r["total_loss"] for r in sorted(rows, key=lambda r: r["step"])])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks (one spawn) and, meanwhile, JAX's runs and the
    one-process references in this process: a dict of the ranks' arrays,
    their logs, JAX's runs, the references and the ranks' directory."""
    outdir = tmp_path_factory.mktemp("ranks")
    np.savez(outdir / "eps.npz", eps=_jax_eps(jax.random.key(7), 3, BATCH))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "from tests.test_torch_parallel_train import rank_main; "
            "rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ENV_VARS:
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i), str(outdir),
                               f"127.0.0.1:{port}"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
             for i in range(RANKS)]
    try:
        jax_runs = _jax_runs(jax_load_critic(CRITIC_NPZ))
        mkldnn = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            reference = _one_process(tmp_path_factory.mktemp("one"))
        finally:
            torch.backends.mkldnn.enabled = mkldnn
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {i}" in out, f"rank {i}:\n{out[-4000:]}"
    got = [dict(np.load(outdir / f"rank{i}.npz")) for i in range(RANKS)]
    logs = [json.loads((outdir / f"logs{i}.json").read_text()) for i in range(RANKS)]
    return {"got": got, "logs": logs, "jax": jax_runs, "one": reference, "dir": outdir}


# ------------------------------------------------------------ the shuffle


@pytest.mark.parametrize("n,batch,devices", [(64, 16, 8), (12, 4, 2), (10, 4, 2), (13, 6, 1),
                                             (96, 12, 4), (7, 2, 1)])
def test_sharded_epoch_indices_are_jaxs(n, batch, devices):
    """Bit for bit JAX's, two epochs from one generator; every local offset
    in its shard, each rank's block a permutation of its rows' prefix."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        got = tstep.sharded_epoch_indices(a, n, batch, devices)
        want = jstep.sharded_epoch_indices(b, n, batch, devices)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        s, pb = n // devices, batch // devices
        assert got.shape == (s // pb, batch) and got.min() >= 0 and got.max() < s
        for d in range(devices):
            block = got[:, d * pb:(d + 1) * pb].ravel()
            assert len(set(block.tolist())) == block.size


@pytest.mark.parametrize("n,batch,devices", [(64, 15, 8), (63, 16, 8), (8, 16, 8)])
def test_sharded_epoch_indices_errors_are_jaxs(n, batch, devices):
    with pytest.raises(ValueError) as want:
        jstep.sharded_epoch_indices(np.random.default_rng(0), n, batch, devices)
    with pytest.raises(ValueError) as got:
        tstep.sharded_epoch_indices(np.random.default_rng(0), n, batch, devices)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the reductions


def test_one_process_mesh_runs_no_collective(monkeypatch):
    """Without a group the reductions are the identity, and a meshed step
    computes exactly as an unmeshed one."""
    m = pmesh.make_mesh(0, "cpu")
    x = torch.arange(4.0, requires_grad=True)
    assert pmesh.global_mean(m, x) is x and pmesh.global_mean(None, x) is x
    grads = [torch.ones(2)]
    assert pmesh.sum_gradients(m, grads) is grads
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda *a, **k: pytest.fail("a collective ran"))
    critic, data = _critic(), torch.from_numpy(_dataset())
    idx = torch.from_numpy(_inputs()[0])
    eps = torch.from_numpy(_jax_eps(jax.random.key(7), 3, BATCH))
    states = [tstep.init_train_state(*_narrow(), device="cpu") for _ in range(2)]
    a = tstep.make_multi_step(critic, learning_rate=LR)(states[0], data, idx, eps)
    b = tstep.make_multi_step(critic, mesh=m, learning_rate=LR)(states[1], data, idx, eps)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    fa, fb = _flat(states[0]), _flat(states[1])
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# ------------------------------------------------------------ the steps


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def _names(tree):
    return ["/".join(k.key for k in path) for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _port_tree(flat, prefix, leaves="params"):
    """A rank's flattened state (``prefix/params/<torch name>``...) as JAX-layout
    params and BN stats; ``leaves`` names the parameter-shaped part to read
    (``opt/mu`` for Adam's first moment, without the BN stats)."""
    vae = weights.vae_from_params(*_narrow())
    names = [n for n, _ in vae.named_parameters()]
    with torch.no_grad():
        for n, p in zip(names, vae.parameters()):
            p.copy_(torch.from_numpy(flat[f"{prefix}/{leaves}/{n}"]))
        for i, bn in enumerate(vae.encoder.bns):
            if leaves != "params":
                break
            bn.running_mean.copy_(torch.from_numpy(flat[f"{prefix}/bn_state/bn{i}/mean"]))
            bn.running_var.copy_(torch.from_numpy(flat[f"{prefix}/bn_state/bn{i}/var"]))
    return weights.vae_to_params(vae)


def _assert_close_to_jax(flat, prefix, jax_state, jax_losses, steps=3):
    for k, want in jax_losses.items():
        np.testing.assert_allclose(flat[f"{prefix}/loss/{k}"].astype(np.float64),
                                   want.astype(np.float64), rtol=LOSS_REL, atol=0, err_msg=k)
    got_p, got_bn = _port_tree(flat, prefix)
    for name in _names(jax_state.params):
        bound = 2 * steps * LR if name in ENC_CONV_BIASES else PARAM_TOL
        err = np.abs(_leaf(got_p, name) - _leaf(jax_state.params, name)).max()
        assert err <= bound, (name, err / LR)
    for i in range(4):
        m, v = got_bn[f"bn{i}"]["mean"], got_bn[f"bn{i}"]["var"]
        assert np.abs(m - _leaf(jax_state.bn_state, f"bn{i}/mean")).max() <= BN_MEAN_ABS
        np.testing.assert_allclose(v, _leaf(jax_state.bn_state, f"bn{i}/var"), rtol=BN_VAR_REL,
                                   atol=0)


def _assert_ranks_equal(ranks, prefix):
    a, b = ranks["got"]
    keys = [k for k in a if k.startswith(prefix + "/")]
    assert keys and keys == [k for k in b if k.startswith(prefix + "/")]
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("loop", ["repl", "shard"])
def test_two_ranks_match_jax(ranks, loop):
    """Two ranks' ``make_multi_step(mesh=)`` against JAX's
    ``make_multi_step``, and their ``make_sharded_multi_step`` against JAX's
    over a 2-device mesh, with JAX's draws; the ranks bitwise equal."""
    jax_state, jax_losses = ranks["jax"][loop]
    for flat in ranks["got"]:
        _assert_close_to_jax(flat, loop, jax_state, jax_losses)
    _assert_ranks_equal(ranks, loop)


def test_step_one_gradient_matches_jax(ranks):
    """Adam's first moment after step 1 is 0.1 times the gradient: the
    global batch's gradient, with every cross-rank term, on both ranks."""
    want = ranks["jax"]["mu1"]
    for flat in ranks["got"]:
        got, _ = _port_tree(flat, "mu1", "opt/mu")
        for name in _names(want):
            if name in ENC_CONV_BIASES:
                continue
            w, g = _leaf(want, name), _leaf(got, name)
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= MU_REL, (name, rel)
    _assert_ranks_equal(ranks, "mu1")


def test_nan_on_one_rank_skips_on_both(ranks):
    for flat in ranks["got"]:
        np.testing.assert_array_equal(flat["nan/counters"], [1, 0, 1, 1])
        assert flat["nan/unchanged"]


# ------------------------------------------------------------ train()


def test_train_matches_one_process(ranks):
    """The per-step losses of metrics.jsonl (every step logged) against one
    process: replicated, its own train(); sharded, its steps over the global
    rows of the same sharded shuffle. The final states bitwise equal on the
    two ranks."""
    out = ranks["dir"]
    for name in ("repl", "shard"):
        np.testing.assert_allclose(_jsonl(out / name), ranks["one"][name], rtol=LOSS_REL,
                                   atol=0, err_msg=name)
        _assert_ranks_equal(ranks, f"train_{name}")
    with open(out / "shard_ckpt" / "ckpt-6.meta.json") as f:
        assert json.load(f)["shard_dataset"] is True
    with open(out / "repl_ckpt" / "ckpt-9.meta.json") as f:
        assert json.load(f)["shard_dataset"] is False


def test_one_rank_writes(ranks):
    """Checkpoints, events and JSONL from the primary alone, and its lines."""
    out = ranks["dir"]
    assert set((out / "writers.txt").read_text().split()) == {"0"}
    for name in ("repl", "shard"):
        files = sorted(os.listdir(out / name))
        assert len(files) == 2 and files[0].startswith("events.out") and files[1] == "metrics.jsonl"
    # every 2 steps at the chunk ends (2, 3 | 5, 6), then at the end; the
    # replicated run's directory then resumed for one more epoch (8, 9)
    for name, steps in (("shard", (2, 5, 6)), ("repl", (6, 8, 9))):
        assert sorted(os.listdir(out / f"{name}_ckpt")) == sorted(
            f"ckpt-{s}.{ext}" for s in steps for ext in ("npz", "meta.json"))
    logs0, logs1 = ranks["logs"]
    assert all(v == "" for k, v in logs1.items() if k not in ("refused", "forced"))
    assert "ep:1, imgs:24" in logs0["repl"] and "resumed from" in logs0["resumed"]


def test_resume_on_two_ranks_is_bitwise(ranks):
    for flat in ranks["got"]:
        for k in (k for k in flat if k.startswith("train_shard/")):
            np.testing.assert_array_equal(flat["resumed/" + k[len("train_shard/"):]], flat[k],
                                          err_msg=k)
    _assert_ranks_equal(ranks, "resumed")


def test_resume_refuses_a_changed_layout_and_takes_old_checkpoints(ranks):
    for logs, flat in zip(ranks["logs"], ranks["got"]):
        assert "run configuration changed" in logs["refused"]
        assert "'shard_dataset': (True, False)" in logs["refused"]
        assert int(flat["old_meta/step"]) == 9  # resumed at 6, one more epoch
    assert "resumed from" in ranks["logs"][0]["old_meta"]


def test_forced_sharding_needs_a_divisible_layout(ranks):
    """``shard_dataset=True`` raises the JAX package's error, word for word,
    where the ranks divide the batch but not the frames."""
    for logs in ranks["logs"]:
        assert logs["forced"] == ("shard_dataset=True needs the dataset (11) and batch size "
                                  "(4) divisible by the mesh size (2)")
