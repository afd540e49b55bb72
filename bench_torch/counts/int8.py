"""Bytes and operations of kernel B4, the int8 build's message (the
product K8 @ y of ``crf/fused_build.py::matvec_i8``): per frame of N pixels
and L lanes it reads the N² int8 K8 once (1 byte an entry), the bf16 y
once (N·L · 2 bytes) and writes the float32 out once (N·L · 4 bytes), and
takes 2·N²·L float32 operations (a multiply-add an entry and lane: int8
and bf16 widened to float32). Kernel B3, which writes K8, is counted by
bytes.py::b2 at 1 byte an entry."""


def b4(frames: int, n: int, lanes: int):
    """(bytes, [(operations, precision)]) of one B4 launch on ``frames``
    frames of ``n`` pixels and ``lanes`` lanes."""
    nbytes = frames * n * n + frames * n * lanes * (2 + 4)
    return nbytes, [(frames * 2 * n * n * lanes, "float32")]
