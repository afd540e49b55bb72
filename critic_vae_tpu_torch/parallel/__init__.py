"""Data parallelism over ``torch.distributed`` ranks, one a device
(counterpart of critic_vae_tpu/parallel): ``distributed.py`` forms the
process group, ``mesh.py`` splits batches over it and gathers them back."""
