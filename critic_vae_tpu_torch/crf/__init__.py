"""Dense-CRF refinement (counterpart of critic_vae_tpu/crf).

Two backends (``policy.py`` picks one): the host C++ permutohedral lattice
(``host.py``: ``densecrf``, ``densecrf_batch``, ``refine_masks``), and the
exact mean field on the device (``device.py``) with its ``xla`` (Gram form),
``pallas`` (kernel B2), ``int8`` (B3, B4, ``fused_build.py``) and ``vmem``
(B5, ``fused_resident.py``) builds.
"""

# The reference's fixed CRF parameter tuple (w1, alpha, beta, w2, gamma,
# iters), as in critic_vae_tpu/crf/__init__.py.
REFERENCE_CRF_PARAMS = (22.0, 12.0, 3.1, 8.0, 1.8, 10)

from critic_vae_tpu_torch.crf.host import densecrf, densecrf_batch, refine_masks  # noqa: E402,F401
