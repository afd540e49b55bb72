"""Dense-CRF refinement (counterpart of critic_vae_tpu/crf).

Two backends (``policy.py`` picks one): the host C++ permutohedral lattice
(``host.py``: ``densecrf``, ``densecrf_batch``, ``refine_masks`` and the
reference's search scaffold ``crf_reference_scaffold``), and the
exact mean field on the device (``device.py``) with its ``xla`` (Gram form),
``pallas`` (kernel B2), ``int8`` (B3, B4, ``fused_build.py``) and ``vmem``
(B5, ``fused_resident.py``) builds, ``densecrf_device`` and the
parameter search ``crf_param_search``.
"""

# The reference's fixed CRF parameter tuple (w1, alpha, beta, w2, gamma,
# iters), as in critic_vae_tpu/crf/__init__.py.
REFERENCE_CRF_PARAMS = (22.0, 12.0, 3.1, 8.0, 1.8, 10)

# the reference's (degenerate, one-combination) grid, vae_utility.py:25-30
DEFAULT_PARAM_GRID = {
    k: [v] for k, v in zip(("w1", "alpha", "beta", "w2", "gamma", "iters"), REFERENCE_CRF_PARAMS)
}

from critic_vae_tpu_torch.crf.host import (  # noqa: E402,F401
    crf_reference_scaffold,
    densecrf,
    densecrf_batch,
    refine_masks,
)
