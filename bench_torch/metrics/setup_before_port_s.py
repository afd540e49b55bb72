"""setup_before_port_s: the seconds from the process's start to the port's
import (``critic_vae_tpu_torch.IMPORT_START_NS``, stamped on
``time.time_ns()`` by the package's first line, less
core.process_start_wall()): the interpreter, the harness's start and
``import torch``. Nothing where the program stamps no import start. The
stamp is read in the process that prints the result line: a cell on
several cards would read its parent process's, not a rank's."""

from bench_torch import core


def read(t):
    import critic_vae_tpu_torch as port

    stamp = getattr(port, "IMPORT_START_NS", None)
    if stamp is None:
        return None
    return stamp / 1e9 - core.process_start_wall()
