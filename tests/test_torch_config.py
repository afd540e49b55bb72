"""The port's typed configuration (critic_vae_tpu_torch/config.py) against
the JAX package's critic_vae_tpu/config.py: every section, field for field
and value for value, and the package's exports."""

import dataclasses

import pytest
import torch

import critic_vae_tpu
import critic_vae_tpu_torch
from critic_vae_tpu import config as jconfig
from critic_vae_tpu_torch import config as tconfig

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

SECTIONS = ("ModelConfig", "TrainConfig", "MaskConfig", "PathConfig", "MeshConfig", "Config")


@pytest.mark.parametrize("root", [".", "/data/run"])
def test_default_config_equals_jaxs(root):
    got, want = tconfig.default_config(root), jconfig.default_config(root)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.paths.root == root
    assert got.mask.crf_params == want.mask.crf_params
    for rel in (got.paths.encoder_path, got.paths.minerl_episode_path, "/abs/file"):
        assert got.paths.resolve(rel) == want.paths.resolve(rel)


@pytest.mark.parametrize("name", SECTIONS)
def test_sections_have_jaxs_fields(name):
    got, want = getattr(tconfig, name), getattr(jconfig, name)
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
        [(f.name, f.type) for f in dataclasses.fields(want)]
    assert got.__dataclass_params__.frozen and want.__dataclass_params__.frozen


def test_replace_and_frozen():
    cfg = tconfig.default_config()
    new = cfg.replace(train=dataclasses.replace(cfg.train, epochs=3))
    assert new.train.epochs == 3 and cfg.train.epochs == 7 and new.paths is cfg.paths
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.train.epochs = 1


def test_the_package_exports_config():
    assert critic_vae_tpu_torch.Config is tconfig.Config
    assert critic_vae_tpu_torch.default_config is tconfig.default_config
    assert {"Config", "default_config"} <= set(dir(critic_vae_tpu))


def test_crf_params_come_from_the_ports_crf():
    from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS

    assert tconfig.default_config().mask.crf_params == REFERENCE_CRF_PARAMS
