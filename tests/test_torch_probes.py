"""The Hopper probes P1 and P2 (critic_vae_tpu_torch.probes) on the CPU:
their plain versions against the TPU probes' numpy expectations and the JAX
package's space-to-depth phase conv, the wrappers' checks, and the entry
points."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.data.synthetic import generate_frames
from critic_vae_tpu.ops import poolconv as jpc
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.ops.mask import merged_conv0_weight
from critic_vae_tpu_torch.ops.poolconv import s2d_pool_weights
from critic_vae_tpu_torch.probes import caps_probe as p1
from critic_vae_tpu_torch.probes import copy_floor_probe as p2

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CPU = torch.device("cpu")


# ------------------------------------------------------------------------ P1


def test_caps_probe_plain_versions_meet_the_tpu_expectations():
    x1, x2, x3, w3 = p1.probe_inputs(CPU)
    e1, e2, e3 = p1.expectations(x1, x2, x3, w3)
    np.testing.assert_array_equal(p1.q1_reference(x1).numpy(), e1)
    np.testing.assert_array_equal(p1.q2_reference(x2).numpy(), e2)
    # the same bf16 values, f32 sums in another order than numpy's
    assert np.abs(p1.q3_reference(x3, w3).numpy() - e3).max() <= 1e-4
    res = p1.run(CPU)
    assert {k: res[k] for k in p1.INSTRUCTIONS} == dict.fromkeys(p1.INSTRUCTIONS, True)
    assert res["platform"] == "cpu"


def test_caps_probe_wrappers_check_and_count_nothing_on_cpu():
    x1, x2, x3, w3 = p1.probe_inputs(CPU)
    kb.reset_launches()
    p1.q1_lane_offset_write(x1)
    p1.q2_phase_max_40(x2)
    p1.q3_fori_dyn_dot(x3, w3)
    assert kb.LAUNCHES == dict.fromkeys(kb.LAUNCHES, 0)
    with pytest.raises(ValueError):
        p1.q1_lane_offset_write(x1[:, :12].contiguous())
    with pytest.raises(ValueError):
        p1.q2_phase_max_40(x2.double())
    with pytest.raises(ValueError):
        p1.q3_fori_dyn_dot(x3.t(), w3)  # (128, 256) view
    with pytest.raises(ValueError):
        p1.q2_phase_max_40(x2.to("meta"))  # neither CPU nor CUDA: no plain fallback


def test_caps_probe_entry_point(tmp_path, capsys):
    out = tmp_path / "caps.json"
    assert p1.main([str(out), "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert set(rec) >= {"platform", "device", "q1_lane_offset_write", "q2_phase_max_40",
                        "q3_fori_dyn_dot"}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            p1.main(["--device", "cuda"])


# ------------------------------------------------------------------------ P2


def _tpu_kernel_numpy(x, w, frames_per_block, copies=True):
    """examples/mosaic_copy_floor_probe.py's kernel body, block by block and
    row by row, in numpy (f32 sums of the bf16 values)."""
    x, w = x.float().numpy(), w.float().numpy()
    frames = x.shape[0] // p2.S2D_ROWS
    out = np.zeros((frames * p2.OUT_ROWS, 40), np.float32)
    for g in range(frames // frames_per_block):
        xb = x[g * frames_per_block * p2.S2D_ROWS:]
        scratch = np.zeros((32 * frames_per_block, 128), np.float32)
        for i in range(32):
            if copies:
                for f in range(frames_per_block):
                    for r in range(3):
                        for t in range(3):
                            row = p2.S2D_ROWS * f + 34 * (i + r) + t
                            scratch[32 * f:32 * f + 32, 36 * r + 12 * t:36 * r + 12 * t + 12] = (
                                xb[row:row + 32])
            acc = scratch @ w
            m = np.maximum(acc[:, :40], np.maximum(acc[:, 40:80],
                                                   np.maximum(acc[:, 80:120], acc[:, 120:])))
            m = np.maximum(m, 0.0)
            for f in range(frames_per_block):
                o = (g * frames_per_block + f) * p2.OUT_ROWS + 32 * i
                out[o:o + 32] = m[32 * f:32 * f + 32]
    return out


@pytest.mark.parametrize("copies", [True, False], ids=["copies_and_dot", "dot_only"])
def test_front_end_probe_plain_matches_the_tpu_kernel(copies):
    x, w = p2.probe_inputs(4, CPU)
    want = _tpu_kernel_numpy(x, w, frames_per_block=2, copies=copies)
    got = p2.front_end_probe(x, w, frames_per_block=2, copies=copies)
    assert got.dtype == torch.bfloat16 and got.shape == (4 * 1024, 40)
    # one bf16 rounding of the f32 result (2^-8 relative), f32 order on top
    assert np.all(np.abs(got.float().numpy() - want) <= 2.0 ** -8 * np.abs(want) + 1e-6)
    if not copies:
        assert not got.any()


LINE = p2.S2D_SIDE * p2.S2D_C  # 408 bf16 of a frame's s2d scanline


@pytest.mark.parametrize("frame", [0, 1, 3])
def test_window_view_is_the_im2col_slab(frame):
    """The kernel's A operand of output row i is a strided view of the
    frame's own flat s2d input, entry (j, 36 r + m) at 408 (i + r) + 12 j +
    m: no im2col copy is needed."""
    x, _ = p2.probe_inputs(4, CPU)
    flat = x.view(-1)[frame * p2.S2D_ROWS * p2.S2D_C:(frame + 1) * p2.S2D_ROWS * p2.S2D_C]
    slab = x[p2.im2col_rows(4, CPU)].reshape(4, p2.OUT_SIDE, p2.OUT_SIDE, p2.PATCH)
    for i in range(p2.OUT_SIDE):
        window = torch.as_strided(flat, (p2.OUT_SIDE, 3, 36), (p2.S2D_C, LINE, 1),
                                  flat.storage_offset() + LINE * i)
        assert torch.equal(window.reshape(p2.OUT_SIDE, p2.PATCH), slab[frame, i])
    # the pad's window reads (k = 108..111, "r = 3") of row 31 land on the
    # next frame's first scanline: why the kernel zeroes them
    k = torch.arange(p2.PATCH, p2.K_PAD)
    assert (LINE * (31 + k // 36) + (k - 36 * (k // 36))).min() == p2.S2D_ROWS * p2.S2D_C


@pytest.mark.parametrize("pad_fill", [0.0, float("nan"), float("inf")])
def test_padded_k_product_equals_the_patch_product(pad_fill):
    """K padded from 108 to 112 with the pad columns of A zeroed gives the
    108-column product, whatever the pad reads held."""
    x, w = p2.probe_inputs(2, CPU)
    a = x[p2.im2col_rows(2, CPU)].reshape(-1, p2.PATCH).float()
    raw = torch.cat([a, torch.full((a.shape[0], p2.K_PAD - p2.PATCH), pad_fill)], dim=1)
    zeroed = raw.clone()
    zeroed[:, p2.PATCH:] = 0.0
    want = a @ w[:p2.PATCH].float()
    assert torch.equal(zeroed @ w[:p2.K_PAD].float(), want)
    if pad_fill != 0.0:  # unmasked, the pad poisons every output (NaN or Inf)
        assert not torch.isfinite(raw @ w[:p2.K_PAD].float()).any()


def test_front_end_probe_plain_is_the_s2d_phase_conv():
    """On s2d'd frames and the merged 3->40 weights, the probe computes ReLU
    of the pool-phase max of the JAX package's s2d_conv_pool2_phases."""
    frames, _ = generate_frames(4, seed=7)
    critic, vae = weights.synthetic_models(CPU)
    wm = merged_conv0_weight(vae, critic).to(torch.bfloat16)          # (40, 3, 5, 5)
    x = (torch.from_numpy(frames).float() / 255.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    xo, wo = p2.pack_frames(x), p2.pack_weights(wm)
    assert xo.shape == (4 * 1156, 12) and wo.shape == (128, 160) and not wo[108:].any()
    got = p2.front_end_probe(xo, wo).float().numpy()
    xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy())
    wj = jnp.asarray(wm.float().permute(2, 3, 1, 0).numpy())
    want = np.asarray(jnp.maximum(jpc.s2d_conv_pool2_phases(xj, wj).max(3), 0)).reshape(-1, 40)
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6)
    port = p2.pooled_phase_relu(x.float(), wm.float()).numpy()
    assert np.abs(port - want).max() <= 1e-5
    # the library path that the probe times beside the fused one: the same
    # function in NCHW, f32 sums in cuDNN's order
    lib = p2.library_front_end(x.float(), s2d_pool_weights(wm.float()))
    assert lib.shape == (4, 40, 32, 32)
    assert np.abs(lib.permute(0, 2, 3, 1).reshape(-1, 40).numpy() - want).max() <= 1e-5


def test_front_end_probe_wrapper_checks_and_counts_nothing_on_cpu():
    x, w = p2.probe_inputs(4, CPU)
    kb.reset_launches()
    p2.front_end_probe(x, w, frames_per_block=4)
    p2.front_end_probe(x, w, copies=False)
    assert kb.LAUNCHES == dict.fromkeys(kb.LAUNCHES, 0)
    with pytest.raises(ValueError):
        p2.front_end_probe(x[:-1], w)
    with pytest.raises(ValueError):
        p2.front_end_probe(x, w[:108])
    with pytest.raises(TypeError):
        p2.front_end_probe(x.float(), w)
    with pytest.raises(ValueError):
        p2.front_end_probe(x, w, frames_per_block=3)  # 4 frames
    with pytest.raises(ValueError):
        p2.front_end_probe(x, w, frames_per_block=1)  # wgmma's 64-row tile takes frame pairs
    with pytest.raises(ValueError):
        p2.front_end_probe(x.to("meta"), w.to("meta"))
    # w (112, 160) and three frame pairs with their two mbarriers fit one block
    assert p2.smem_bytes() == 112 * 160 * 2 + 3 * (2 * 1156 * 12 * 2 + 16) <= p2.SMEM_LIMIT


def test_copy_floor_probe_entry_point(tmp_path, monkeypatch):
    monkeypatch.setenv("PROBE_F", "2")
    out = tmp_path / "floor.json"
    assert p2.main([str(out), "--device", "cpu", "--frames", "4"]) == 0
    rec = json.loads(out.read_text())
    assert rec["platform"] == "cpu" and rec["frames_per_block"] == 2
    # the TPU probe's meaning, B·32·9 im2col copies; the bulk copies beside it
    assert rec["copies_per_batch"] == 4 * 32 * 9
    assert rec["bulk_copies_per_batch"] == 4  # one bulk copy a frame
    assert "must be even" in rec["frames_per_block_note"]
    assert "dot_only_ms" not in rec  # no device time from a CPU run
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            p2.main(["--device", "cuda"])
