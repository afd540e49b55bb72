"""Bytes and operations of kernel B2, the bilateral build
(``chip_smoke.py::crf_bounds``, copied): per frame of N pixels it reads the
N·3 uint8 frame once and writes the N² matrix M once (bf16: 2 bytes an
entry), and computes each of the N(N−1)/2 distinct entries of the
symmetric K once at 16 float32 operations (5 feature differences, 5
squares, 4 sums, 1 scale, 1 exp), a lower count, as a bound wants."""

ENTRY_OPS = 16


def b2(frames: int, n: int, m_bytes: int = 2):
    """(bytes, [(operations, precision)]) of one B2 launch on ``frames``
    frames of ``n`` pixels."""
    nbytes = frames * n * 3 + frames * n * n * m_bytes
    return nbytes, [(frames * n * (n - 1) // 2 * ENTRY_OPS, "float32")]
