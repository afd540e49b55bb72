"""Typed configuration (counterpart of critic_vae_tpu/config.py).

The reference's constants (its vae_parameters.py) as frozen dataclasses,
field for field and value for value the JAX package's, so both packages'
command lines take their defaults from one layout. ``MeshConfig`` keeps the
JAX package's fields: in the port a mesh is one process (rank) a device,
formed by ``torch.distributed`` (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS as _CRF


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VAE and critic architecture (reference: vae_parameters.py:5-17,
    vae_nets.py:8, critic_net.py:6-7)."""

    image_size: int = 64
    channels: int = 3
    kernel_size: int = 5
    padding: int = 2
    stride: int = 1
    encoder_dims: Tuple[int, ...] = (32, 64, 128, 256)
    bottleneck: int = 4096  # 4*4*256 conv bottleneck
    latent_dim: int = 32
    critic_dims: Tuple[int, ...] = (8, 8, 8, 16)
    critic_bottleneck: int = 32
    inject_n: int = 6  # injected critic values (vae_parameters.py:22)
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation (reference: vae_parameters.py:9-21, vae.py:36)."""

    epochs: int = 7
    batch_size: int = 128
    learning_rate: float = 5e-5
    kld_weight: float = 1e-3
    total_images: int = 50_000
    log_every_batches: int = 30  # log_n = batch_size*30 (vae_parameters.py:21)
    seed: int = 0
    drop_remainder: bool = True  # the reference's index slicing (vae.py:44-46)
    checkpoint_every_steps: int = 500
    keep_checkpoints: int = 3


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Mask and video pipeline (reference: vae_utility.py:17, vae.py:121)."""

    threshold: int = 50
    threshold_sweep: Tuple[int, ...] = tuple(range(0, 130, 10))
    # the dense CRF's (w1, alpha, beta, w2, gamma, iters), vae_utility.py:25-30
    crf_w1: float = _CRF[0]
    crf_alpha: float = _CRF[1]
    crf_beta: float = _CRF[2]
    crf_w2: float = _CRF[3]
    crf_gamma: float = _CRF[4]
    crf_iters: int = _CRF[5]

    @property
    def crf_params(self) -> Tuple[float, float, float, float, float, int]:
        return (self.crf_w1, self.crf_alpha, self.crf_beta,
                self.crf_w2, self.crf_gamma, self.crf_iters)
    # the episode slice frames[100:5000:2] (vae_utility.py:75-77)
    episode_slice: Tuple[int, int, int] = (100, 5000, 2)
    # critic-binned balanced sampling (vae_utility.py:404,431-457)
    bin_collect_per_trajectory: int = 150
    bin_low_max: float = 0.25
    bin_mid_lo: float = 0.4
    bin_mid_hi: float = 0.6
    bin_high_min: float = 0.7


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Files under ``root`` (reference: vae_parameters.py:25-41).
    ``critic_path`` is the reference's critic, which the repo does not hold:
    the port's command line defaults ``--critic`` to the repo's synthetic
    critic instead (cli.py)."""

    root: str = "."
    encoder_path: str = "saved-networks/vae_encoder.ckpt"
    decoder_path: str = "saved-networks/vae_decoder.ckpt"
    second_encoder_path: str = "vae2_encoder.ckpt"
    second_decoder_path: str = "vae2_decoder.ckpt"
    critic_path: str = (
        "saved-networks/critic-rewidx=1-cepochs=15-datamode=trunk-"
        "datasize=99999-shift=12-chfak=1-dropout=0.3.pt"
    )
    source_images_path: str = "source-images"
    save_path: str = "images"
    inject_path: str = "inject"
    video_path: str = "videos"
    save_dataset_path: str = "recon-dataset.npz"
    minerl_episode_path: str = "minerl-episode"
    log_dir: str = "logs"

    def resolve(self, rel: str) -> Path:
        p = Path(rel)
        return p if p.is_absolute() else Path(self.root) / p


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The data-parallel mesh: one axis; ``num_devices`` 0 is every rank."""

    data_axis: str = "data"
    num_devices: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mask: MaskConfig = dataclasses.field(default_factory=MaskConfig)
    paths: PathConfig = dataclasses.field(default_factory=PathConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


def default_config(root: str = ".") -> Config:
    cfg = Config()
    return cfg.replace(paths=dataclasses.replace(cfg.paths, root=root))
