"""critic_vae_tpu_torch — the PyTorch/CUDA port of critic_vae_tpu for an
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``critic_vae_tpu`` stays the reference: every module here
keeps its counterpart's name, and public functions keep its layouts (frames
(B, H, W, 3), grey maps (B, H, W), CRF inputs (C, N, 3) uint8), so the two
can be held against each other on the same inputs. Inside, models run NCHW
as ``nn.Module``s and every function takes an explicit ``device``.

Besides the diff mask source it carries the critic's saliency masks
(``ops/saliency.py``, the ``--quality`` chain), the device CRF's
``densecrf_device`` and parameter search, image eval and inject
(``pipelines/evaluate.py``) and VAE training (``train/step.py``,
``pipelines/train.py``, the ``train`` command). The TPU kernels on the mask-video
path, its threshold sweep and the ``int8``/``vmem`` CRF builds, and the
probes of the fused front-end kernel
(``probes/``), are hand-written CUDA C++ under ``csrc/`` (built by
``kernels/build.py`` at first use); each wrapper takes its plain PyTorch
version only for CPU tensors. The command line (``cli.py``) takes its defaults from
``config.py``; ``parallel/`` runs the serving path over ``torch.distributed``
ranks, one a device, and ``utils/profiling.py`` takes ``--profile``'s trace.
This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from critic_vae_tpu_torch.config import Config, default_config  # noqa: E402,F401
