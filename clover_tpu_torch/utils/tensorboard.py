"""Dependency-free TensorBoard scalar event writer.

Equivalent of the reference's TensorboardLoggerHook
(configs/_base_/default_runtime.py:2-7 wiring mmcv's hook): writes
``events.out.tfevents.*`` files a stock TensorBoard can read. Implemented
directly against the on-disk format — TFRecord framing (length + masked
crc32c) around hand-encoded ``tensorflow.Event`` protobuf messages with
``simple_value`` scalar summaries — so the runtime needs neither
tensorflow nor the tensorboard package (tests use the installed
tensorboard reader to prove compatibility).

Port of ``clover_tpu/utils/tensorboard.py``: a copy, held against it by ``tests/test_torch_trainer.py``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# --------------------------------------------------- protobuf wire format


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }; Summary{ value=1 }
    sv = _len_delim(1, tag.encode("utf-8")) + _float(2, float(value))
    summary = _len_delim(1, sv)
    # Event{ wall_time=1(double), step=2(int64), summary=5 }
    return _double(1, wall_time) + _int64(2, int(step)) + _len_delim(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3(string) }
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------------------- writer


class TensorBoardWriter:
    """Append scalar summaries to an events file under ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(log_dir, fname)
        self._fh = open(self.path, "ab")
        self._fh.write(_tfrecord(_file_version_event(time.time())))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        wall_time = time.time() if wall_time is None else wall_time
        self._fh.write(_tfrecord(_scalar_event(tag, value, step, wall_time)))

    def add_scalars(self, payload: Dict[str, float], step: int,
                    prefix: str = "") -> None:
        now = time.time()
        for k, v in payload.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            self.add_scalar(prefix + k, fv, step, now)
        self.flush()

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()
