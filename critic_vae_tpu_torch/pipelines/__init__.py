"""Video pipeline: the device stage and ``eval_episode``."""
