"""Dense-CRF refinement on the device (counterpart of critic_vae_tpu/crf).

Only the exact device mean-field (``device.py``) is ported, with its
``auto``/``pallas`` (kernel B2), ``int8`` (B3, B4, ``fused_build.py``) and
``vmem`` (B5, ``fused_resident.py``) builds; the host C++ permutohedral
lattice waits (ROADMAP A.5).
"""

# The reference's fixed CRF parameter tuple (w1, alpha, beta, w2, gamma,
# iters), as in critic_vae_tpu/crf/__init__.py.
REFERENCE_CRF_PARAMS = (22.0, 12.0, 3.1, 8.0, 1.8, 10)
