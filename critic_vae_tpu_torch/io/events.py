"""TensorBoard event writer written by hand (a copy of
critic_vae_tpu/io/events.py: scalars, histograms, images, and the
``MetricLogger`` with its JSONL mirror).

Replaces the reference's torch ``SummaryWriter`` wrapper (reference:
logger.py:3-15) without tensorboard: encodes Event protos and the TFRecord
framing (masked CRC32C) by hand. Files written here open in stock
TensorBoard, and their bytes equal the JAX package's but for the wall
times. Copied, not imported: importing the JAX package's module runs its
package ``__init__``, which imports jax. Pillow is imported only to encode
an image.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

_CRC_TABLE = []


def _crc32c_init():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_crc32c_init()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _encode_event(
    wall_time: float, step: int, tag: Optional[str], value: Optional[float],
    file_version: Optional[str] = None,
) -> bytes:
    # Event proto: 1=wall_time(double) 2=step(int64) 3=file_version(string)
    #              5=summary(Summary); Summary.Value: 1=tag 2=simple_value
    ev = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        ev += _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _bytes_field(3, file_version.encode())
    if tag is not None:
        val = _bytes_field(1, tag.encode()) + _field(2, 5) + struct.pack("<f", value)
        ev += _bytes_field(5, _bytes_field(1, val))
    return ev


def _frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class EventWriter:
    """Append-only scalar event file (``events.out.tfevents.*``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        # microsecond + pid suffix: two writers starting within the same
        # wall-clock second (e.g. a quick crash-resume) must NOT share a
        # file — interleaved TFRecord frames fail CRC and TensorBoard
        # silently drops everything after the first bad record
        fname = (
            f"events.out.tfevents.{time.time():.6f}."
            f"{socket.gethostname()}.{os.getpid()}"
        )
        self._path = os.path.join(log_dir, fname)
        self._lock = threading.Lock()
        self._f = open(self._path, "ab")
        self._write(_encode_event(time.time(), 0, None, None, file_version="brain.Event:2"))

    @property
    def path(self) -> str:
        return self._path

    def _write(self, event: bytes) -> None:
        with self._lock:
            self._f.write(_frame_record(event))
            self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        """Log one scalar (reference: logger.py:9-11 scalar_summary)."""
        self._write(_encode_event(time.time(), step, tag, float(value)))

    def histogram(self, tag: str, values, step: int, bins: int = 30) -> None:
        """Log a histogram (the reference's histo_summary is broken —
        logger.py:13-15 passes kwargs add_histogram doesn't accept; this one
        works)."""
        import numpy as np

        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        counts, edges = np.histogram(v, bins=bins)
        # HistogramProto: 1=min 2=max 3=num 4=sum 5=sum_squares
        #                 6=bucket_limit (packed double) 7=bucket (packed double)
        h = _field(1, 1) + struct.pack("<d", float(v.min()))
        h += _field(2, 1) + struct.pack("<d", float(v.max()))
        h += _field(3, 1) + struct.pack("<d", float(v.size))
        h += _field(4, 1) + struct.pack("<d", float(v.sum()))
        h += _field(5, 1) + struct.pack("<d", float((v * v).sum()))
        limits = b"".join(struct.pack("<d", float(e)) for e in edges[1:])
        h += _field(6, 2) + _varint(len(limits)) + limits
        buckets = b"".join(struct.pack("<d", float(c)) for c in counts)
        h += _field(7, 2) + _varint(len(buckets)) + buckets
        # Summary.Value: 1=tag 5=histo
        val = _bytes_field(1, tag.encode()) + _bytes_field(5, h)
        ev = (
            _field(1, 1) + struct.pack("<d", time.time())
            + _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
            + _bytes_field(5, _bytes_field(1, val))
        )
        self._write(ev)

    def image(self, tag: str, img, step: int) -> None:
        """Log an image (the reference's image_summary is commented out —
        logger.py:17-28; this one works and renders in TB's Images tab).

        ``img``: (H, W) or (H, W, 1|3|4), uint8 or float in [0, 1].
        """
        import io

        import numpy as np
        from PIL import Image as PILImage

        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = arr[..., None]
        h, w, c = arr.shape
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[c]
        pil = PILImage.fromarray(arr[..., 0] if c == 1 else arr, mode=mode)
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        # Summary.Image proto: 1=height 2=width 3=colorspace
        #                      4=encoded_image_string (PNG)
        im = _field(1, 0) + _varint(h) + _field(2, 0) + _varint(w)
        im += _field(3, 0) + _varint({1: 1, 3: 3, 4: 4}[c])
        im += _bytes_field(4, buf.getvalue())
        # Summary.Value: 1=tag 4=image
        val = _bytes_field(1, tag.encode()) + _bytes_field(4, im)
        ev = (
            _field(1, 1) + struct.pack("<d", time.time())
            + _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
            + _bytes_field(5, _bytes_field(1, val))
        )
        self._write(ev)

    def close(self) -> None:
        with self._lock:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MetricLogger:
    """Train-loop metric logging: TB events + JSONL mirror.

    Covers the reference's log_info cadence (vae_utility.py:372-380 — recon,
    kld, total every ``log_n`` images at step ``batch_i + num_samples·ep``).
    """

    def __init__(self, log_dir: str):
        self.events = EventWriter(log_dir)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: dict, step: int) -> None:
        import json

        for tag, value in metrics.items():
            self.events.scalar(tag, value, step)
        self._jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self.events.close()
        self._jsonl.close()
