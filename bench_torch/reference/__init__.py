"""The plain reference: the configurations' mathematics in plain ``torch``
float32 with TF32 off, from the published description, importing no
module of the port. It decides ``correct``."""

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """float32 without TF32 in convs or matmuls for the body of the
    ``with``; the flags are restored after it."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
