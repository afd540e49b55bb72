"""The conv blocks' epilogues of the mask stage (critic_vae_tpu_torch/ops/
epilogue.py, kernel ``csrc/block_epilogue.cu``).

On the CPU: the plain ``pool`` and ``shuffle`` epilogues are bitwise the
ATen chains the blocks ran before them (``batchnorm_eval``, the critic's and
the merged front end's chains, ops/upconv.py's interleave) at every block
shape of the reference model, the front end's channel slices included, at
batch 512 and the 402-frame tail, with ±inf, NaN and -0.0 in the input; the
entry points refuse what the kernel cannot take rather than fall back;
``episode_forward`` routed to the kernel's path (``fused`` faked to hold on
the CPU, the launch stood in for by the same arithmetic on the kernel's
constants) is bitwise the ATen path, 11 epilogues a chunk merged and 12
split, each in a ``block.epilogue`` span; training, the saliency source,
autograd and bfloat16 keep the ATen chain.

On the card (marked ``card``, skipped without one): the kernel bitwise the
plain version at every block shape at 512 and 402 frames, ``episode_forward``
over one 2,450-frame episode bitwise with and without the kernel, and
``LAUNCHES["block_epilogue"]`` a chunk. No JAX here: the card's machine has
none, so the file runs there without tests/conftest.py, which imports it:

    python -m pytest --noconftest tests/test_torch_block_epilogue.py -m card
"""

import pytest
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.ops import epilogue
from critic_vae_tpu_torch.ops.epilogue import batchnorm_eval
from critic_vae_tpu_torch.ops.mask import episode_forward

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
BATCHES = (512, 402)  # a chunk, and the tail of a 2,450-frame episode

# (name, C, H, n_norm, relu) of every pool epilogue of the reference model at
# 64x64: the merged front end (32 encoder + 8 critic channels), the split
# first blocks, encoder blocks 1-3 (the last without ReLU: tanh after) and
# critic blocks 1-3
POOL_SHAPES = [("merged", 40, 64, 32, True), ("enc0", 32, 64, 32, True),
               ("critic0", 8, 64, 0, True), ("enc1", 64, 32, 64, True),
               ("enc2", 128, 16, 128, True), ("enc3", 256, 8, 256, False),
               ("critic1", 8, 32, 0, True), ("critic2", 8, 16, 0, True),
               ("critic3", 16, 8, 0, True)]
# (name, C, H, relu) of the decoder's four phase-split stages: the phase conv
# output is (2B, 4C, H, H)
SHUFFLE_SHAPES = [("up1", 64, 4, True), ("up2", 32, 8, True), ("up3", 32, 16, True),
                  ("up4", 3, 32, False)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaN payloads and the sign of zero included."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _conv_out(shape, seed, device="cpu") -> torch.Tensor:
    """A float32 conv output with specials: ±inf, NaN, -0.0 and exact
    zeros at the start of every plane, a window all -inf at its end."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g)
    specials = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0, 0.0])
    y.view(*shape[:2], -1)[..., : specials.numel()] = specials
    y[..., -2:, -2:] = float("-inf")
    return y.to(device)


def _bn(c: int, seed: int) -> torch.nn.BatchNorm2d:
    g = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c, eps=1e-5).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.25)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
        bn.weight[0] = -bn.weight[0].abs()  # a negative scale: (v − m)·inv gives −0.0
    return bn


def _case(c: int, n_norm: int, seed: int, device="cpu"):
    """(bias of the C channels, the BN of the first n_norm, ``pool_epilogue``'s
    (bias, bn, tail_bias)) on ``device``."""
    g = torch.Generator().manual_seed(seed + 1)
    bias = torch.randn(c, generator=g).to(device)
    if not n_norm:
        return bias, None, (bias, None, None)
    bn = _bn(n_norm, seed).to(device)
    return bias, bn, (bias[:n_norm], bn, bias[n_norm:] if n_norm < c else None)


def _aten_pool_chain(y, bias, bn, n_norm, relu):
    """The blocks' chains as they ran before the kernel: the encoder's
    batchnorm_eval → pool → ReLU (the last block's output before its tanh),
    the critic's (conv + bias) → ReLU → pool, the merged front end both."""
    c = y.shape[1]
    enc = crit = None
    if n_norm:
        enc = F.max_pool2d(batchnorm_eval(bn, y[:, :n_norm], bias[:n_norm]), 2)
        enc = F.relu(enc) if relu else enc
    if n_norm < c:
        crit = F.max_pool2d(F.relu(y[:, n_norm:] + bias[n_norm:].to(y.dtype)[:, None, None]), 2)
    return enc, crit


def _check_pool(out, want, n_norm, c):
    if n_norm:
        assert _same(out[0], want[0])
    else:
        assert out[0].shape[1] == 0
    if n_norm < c:
        assert _same(out[1], want[1])
    else:
        assert out[1].shape[1] == 0


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name, c, h, n_norm, relu", POOL_SHAPES)
def test_pool_reference_is_the_aten_chain(name, c, h, n_norm, relu, batch):
    y = _conv_out((batch, c, h, h), seed=c + h)
    bias, bn, args = _case(c, n_norm, seed=h)
    out = epilogue.pool_epilogue(y, *args, relu=relu)  # a CPU tensor: the plain version
    _check_pool(out, _aten_pool_chain(y, bias, bn, n_norm, relu), n_norm, c)
    if name == "enc3":  # the last block: tanh after, as the encoder applies it
        assert _same(torch.tanh(out[0]), torch.tanh(_aten_pool_chain(y, bias, bn, n_norm,
                                                                     False)[0]))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name, c, h, relu", SHUFFLE_SHAPES)
def test_shuffle_reference_is_the_aten_chain(name, c, h, relu, batch):
    y = _conv_out((2 * batch, 4 * c, h, h), seed=c + h)
    b = torch.randn(c, generator=torch.Generator().manual_seed(h))
    want = F.pixel_shuffle(y, 2) + b[:, None, None]
    want = F.relu(want) if relu else want
    assert _same(epilogue.shuffle_epilogue(y, b, relu), want)


def test_wrappers_check_their_inputs_and_count_nothing_on_the_cpu():
    kb.reset_launches()
    y = _conv_out((2, 8, 16, 16), seed=0)
    bias = torch.zeros(8)
    epilogue.pool_epilogue(y, bias)
    epilogue.pool_epilogue(y, torch.zeros(4), _bn(4, 0), torch.zeros(4))
    epilogue.shuffle_epilogue(y, torch.zeros(2), True)
    assert kb.LAUNCHES["block_epilogue"] == 0
    with pytest.raises(ValueError):
        epilogue.pool_epilogue(y[0], bias)  # not (B, C, H, W)
    with pytest.raises(ValueError):
        epilogue.pool_epilogue(y, bias, _bn(4, 0))  # a bias of another width than the BN's
    with pytest.raises(ValueError):
        epilogue.pool_epilogue(y, torch.zeros(4), _bn(4, 0))  # no bias for the other 4
    with pytest.raises(ValueError):
        epilogue.pool_epilogue(y, torch.zeros(9), _bn(9, 0))  # BN channels past C
    with pytest.raises(ValueError):
        epilogue.pool_epilogue(y[..., :12], bias)  # W not a multiple of 8
    with pytest.raises(ValueError):
        epilogue.pool_epilogue(y[..., :15, :], bias)  # H odd
    with pytest.raises(ValueError):
        epilogue.shuffle_epilogue(y[:, :6], torch.zeros(1), True)  # not 4C channels
    with pytest.raises(ValueError):
        epilogue.shuffle_epilogue(y, torch.zeros(3), True)  # a bias of another width


def test_fused_holds_only_for_float32_on_the_card_without_autograd():
    y = torch.zeros((1, 4, 8, 8))
    with torch.inference_mode():
        assert not epilogue.fused(y)  # the CPU
        meta = torch.zeros((1, 4, 8, 8), device="meta")
        assert not epilogue.fused(meta)


def test_the_kernels_path_refuses_what_it_cannot_take_and_never_falls_back(monkeypatch):
    """Where ``fused`` holds, a tensor the kernel cannot take raises: the
    entry points do not run the plain chain in its place."""
    monkeypatch.setattr(epilogue, "fused", lambda y: True)
    y = _conv_out((2, 8, 16, 16), seed=0)
    unaligned = torch.empty(y.numel() + 1)[1:].view(y.shape)  # 4 bytes past the allocation
    with pytest.raises(ValueError, match="aligned"):
        epilogue.pool_epilogue(unaligned, torch.zeros(8))
    with pytest.raises(ValueError, match="aligned"):
        epilogue.shuffle_epilogue(unaligned, torch.zeros(2), True)
    with pytest.raises(ValueError, match="W % 8"):
        epilogue.pool_epilogue(y[..., :12].contiguous(), torch.zeros(8))
    with pytest.raises(TypeError, match="float32"):
        epilogue.shuffle_epilogue(y, torch.zeros(2, dtype=torch.float64), True)


def test_frozen_constants_are_rebuilt_when_a_weight_changes():
    bn, bias = _bn(4, 0), torch.zeros(4)
    cache = {}
    a = epilogue.pool_params(cache, bias, bn)
    assert epilogue.pool_params(cache, bias, bn) is a
    with torch.no_grad():
        bn.running_var.mul_(2.0)  # an in-place load moves the version
    b = epilogue.pool_params(cache, bias, bn)
    assert b is not a
    assert torch.equal(b[2], torch.rsqrt(bn.running_var + bn.eps) * bn.weight)
    assert torch.equal(b[0], bias) and torch.equal(b[1], bn.running_mean)
    assert torch.equal(b[3], bn.bias)


# --- the glue, on the CPU: the wrappers run their plain versions


def _nets(device="cpu", **vae_kw):
    critic = weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ)).to(device)
    vae = weights.vae_from_params(*weights.numpy_vae_params(3, **vae_kw)).to(device)
    for i, bn in enumerate(vae.encoder.bns):  # running stats away from (0, 1)
        fresh = _bn(bn.num_features, 10 + i)
        bn.load_state_dict(fresh.state_dict())
    return vae.eval(), critic.eval()


def _kernel_arithmetic(y, params, n_norm, relu):
    """The pool kernel's arithmetic in torch, on its constants: (4, C) rows
    of bias, mean, inv and beta (pool_params), or the (C,) bias alone."""
    c = y.shape[1]
    rows = params.reshape(-1, c)
    col = lambda v: v[:, None, None]  # noqa: E731
    out = [y.new_empty((y.shape[0], 0, y.shape[2] // 2, y.shape[3] // 2))] * 2
    if n_norm:
        x = (y[:, :n_norm] + col(rows[0, :n_norm]) - col(rows[1, :n_norm])) * col(rows[2, :n_norm])
        out[0] = F.max_pool2d(x + col(rows[3, :n_norm]), 2)
        out[0] = F.relu(out[0]) if relu else out[0]
    if n_norm < c:
        out[1] = F.max_pool2d(F.relu(y[:, n_norm:] + col(rows[0, n_norm:])), 2)
    return tuple(out)


@pytest.fixture
def routed(monkeypatch):
    """``fused`` faked to hold on the CPU (float32, no autograd), each
    launch stood in for by the kernel's arithmetic on the constants it would
    get and recorded as (form, BN channels or relu)."""
    calls = []

    def fake_fused(y):
        return y.dtype == torch.float32 and not torch.is_grad_enabled()

    def pool_kernel(y, params, n_norm, relu):
        calls.append(("pool", n_norm))
        return _kernel_arithmetic(y, params, n_norm, relu)

    def shuffle_kernel(y, bias, relu):
        calls.append(("shuffle", relu))
        out = F.pixel_shuffle(y, 2) + bias[:, None, None]
        return F.relu(out) if relu else out

    monkeypatch.setattr(epilogue, "fused", fake_fused)
    monkeypatch.setattr(epilogue, "_pool_kernel", pool_kernel)
    monkeypatch.setattr(epilogue, "_shuffle_kernel", shuffle_kernel)
    return calls


def _forward(vae, critic, frames, **kw):
    out = {}
    for start in range(0, frames.shape[0], 4):  # chunks of 4, the last ragged
        got = episode_forward(vae, critic, frames[start:start + 4], **kw)
        for k, v in got.items():
            out.setdefault(k, []).append(v)
    return {k: torch.cat(v) for k, v in out.items()}


MERGED_CHUNK = ([("pool", 32)] + [("pool", n) for n in (64, 128, 256)] + [("pool", 0)] * 3
                + [("shuffle", True)] * 3 + [("shuffle", False)])
SPLIT_CHUNK = ([("pool", 0)] * 4 + [("pool", n) for n in (32, 64, 128, 256)]
               + [("shuffle", True)] * 3 + [("shuffle", False)])


@pytest.mark.parametrize("front_end, per_chunk", [("merged", MERGED_CHUNK),
                                                  ("split", SPLIT_CHUNK)])
def test_episode_forward_through_the_epilogues_is_bitwise_the_aten_path(routed, front_end,
                                                                         per_chunk):
    frames = torch.from_numpy(generate_frames(6, seed=1)[0])
    vae, critic = _nets()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _forward(vae, critic, frames, front_end=front_end, with_recons=True)
    assert sorted(routed) == sorted(per_chunk * 2)
    assert sum(1 for e in prof.events() if e.name == epilogue.SPAN) == 2 * len(per_chunk)
    routed.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epilogue, "fused", lambda y: False)
        want = _forward(vae, critic, frames, front_end=front_end, with_recons=True)
    assert not routed
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k], want[k]), k


def test_autograd_training_and_the_saliency_source_keep_the_aten_chain(routed):
    frames = torch.from_numpy(generate_frames(4, seed=2)[0])
    x = frames.float().permute(0, 3, 1, 2).contiguous() / 255.0
    vae, critic = _nets(**NARROW)
    vae.encode(x)  # eval with autograd recording
    vae.decode(torch.zeros(4, 32), torch.zeros(4))
    critic(x)
    vae.train()
    mu, logvar, stats = vae.encode(x, train=True)
    with torch.no_grad():
        vae.encode(x, train=True)  # train-mode BN, even without autograd
    vae.vae_apply(x, torch.zeros(4), eps=torch.zeros(4, 32))
    vae.eval()
    assert routed == []
    out = episode_forward(vae, critic, frames, mask_source="saliency",
                          saliency_method="layercam")
    assert routed == [] and out["diff"].shape == (4, 64, 64)
    # with_recons decodes under inference_mode: the split encoder and decoder
    episode_forward(vae, critic, frames, mask_source="saliency", with_recons=True)
    assert routed == [("pool", n) for n in (4, 8, 8, 16)] + [("shuffle", True)] * 3 + [
        ("shuffle", False)]


def test_the_train_step_routes_only_the_frozen_critics_labels(routed):
    """The step's critic labels run under ``no_grad`` (the kernel on the
    card, bitwise the chain); the train-mode encode and the differentiated
    decode keep ATen's."""
    from critic_vae_tpu_torch.train import step as tstep

    frames = torch.from_numpy(generate_frames(4, seed=9)[0])
    critic = weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))
    state = tstep.init_train_state(*weights.numpy_vae_params(2, **NARROW), device="cpu")
    step = tstep.make_train_step(critic, learning_rate=5e-5)
    step(state, frames, torch.zeros(4, 32))
    assert routed == [("pool", 0)] * 4


def test_bfloat16_keeps_its_chains_bitwise(routed):
    frames = torch.from_numpy(generate_frames(4, seed=3)[0])
    vae, critic = _nets(**NARROW)
    got = episode_forward(vae, critic, frames, compute_dtype="bfloat16", front_end="merged")
    assert routed == []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epilogue, "fused", lambda y: False)
        want = episode_forward(vae, critic, frames, compute_dtype="bfloat16",
                               front_end="merged")
    for k in want:
        assert _same(got[k], want[k]), k


# --- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block_epilogue kernel runs only there")
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True  # the same convs on both paths
    torch.backends.cudnn.benchmark = False
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


@pytest.mark.card
@pytest.mark.parametrize("batch", BATCHES)
def test_kernel_is_bitwise_the_plain_version_at_every_block_shape(card, batch):
    for _, c, h, n_norm, relu in POOL_SHAPES:
        y = _conv_out((batch, c, h, h), seed=c + h, device=card)
        _, _, args = _case(c, n_norm, seed=h, device=card)
        with torch.inference_mode():
            got = epilogue.pool_epilogue(y, *args, relu=relu)
            want = epilogue.pool_epilogue_reference(y, *args, relu)
        torch.cuda.synchronize()
        _check_pool(got, want, n_norm, c)
    for _, c, h, relu in SHUFFLE_SHAPES:
        y = _conv_out((2 * batch, 4 * c, h, h), seed=c + h, device=card)
        b = torch.randn(c, generator=torch.Generator().manual_seed(h)).to(card)
        with torch.inference_mode():
            got = epilogue.shuffle_epilogue(y, b, relu)
        assert _same(got, epilogue.shuffle_epilogue_reference(y, b, relu))


@pytest.mark.card
def test_a_channels_last_conv_output_takes_the_kernel(card):
    """cuDNN keeps a channels-last input's layout (the saliency stage's
    permuted frames): such a conv output is copied to NCHW and launched,
    bitwise the plain version."""
    y = _conv_out((512, 8, 64, 64), seed=5, device=card).to(memory_format=torch.channels_last)
    bias = torch.randn(8, generator=torch.Generator().manual_seed(5)).to(card)
    assert not y.is_contiguous()
    kb.reset_launches()
    with torch.inference_mode():
        got = epilogue.pool_epilogue(y, bias)
        want = epilogue.pool_epilogue_reference(y, bias)
        got_up = epilogue.shuffle_epilogue(y, bias[:2], True)
    assert kb.LAUNCHES["block_epilogue"] == 2
    _check_pool(got, want, 0, 8)
    assert _same(got_up, epilogue.shuffle_epilogue_reference(y, bias[:2], True))


@pytest.mark.card
@pytest.mark.parametrize("front_end, per_chunk", [("merged", len(MERGED_CHUNK)),
                                                  ("split", len(SPLIT_CHUNK))])
def test_episode_forward_is_bitwise_with_and_without_the_kernel(card, front_end, per_chunk):
    """One 2,450-frame episode in chunks of 512 (the last 402): preds, diff
    and max_value bitwise with the kernel and with the ATen chain on the
    same conv outputs; ``per_chunk`` launches a chunk."""
    frames = torch.from_numpy(generate_frames(2450, seed=6)[0]).to(card)
    vae, critic = _nets(card)

    def run():
        outs = [episode_forward(vae, critic, frames[s:s + 512], front_end=front_end)
                for s in range(0, frames.shape[0], 512)]
        return {k: torch.cat([o[k] for o in outs]) for k in ("preds", "diff", "max_value")}

    kb.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert kb.LAUNCHES["block_epilogue"] == 5 * per_chunk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epilogue, "fused", lambda y: False)
        kb.reset_launches()
        want = run()
        assert kb.LAUNCHES["block_epilogue"] == 0
    for k in want:
        assert _same(got[k], want[k]), k
