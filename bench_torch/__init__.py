"""The benchmark of the PyTorch/CUDA port (``critic_vae_tpu_torch``).

``python bench_torch/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line. Everything the harness needs is found by name: the
configuration in ``configs/<config>.json``, the traffic mix in
``traffic/<traffic>.json``, the cell in ``workloads/<cell>.json`` (its
driver, its check's sample and limits), the driver in
``drivers/<driver>.py``, and each per-layer metric's reader in
``metrics/<metric>.py``. FLOP and byte counts live in ``counts/``, and the
plain float32 reference that decides ``correct`` in ``reference/``; neither
imports the port.
"""
