"""Minimal OpenEXR 2.0 scanline I/O in numpy alone (a copy of
``mitransient_tpu/io_exr.py``).

The reference exports transient frames as EXR through ``mi.Bitmap``
(unpolarized_visualization.py:65-76).  This writes and reads the subset
every EXR consumer reads and the reference itself writes: uncompressed
scanline files of HALF or FLOAT channels.

Layout written (and read back):
  magic 0x01312f76 | version 2 | header attribute list | scanline offset
  table | per-scanline blocks of (y:int32, byte_size:int32, pixel data with
  channels interleaved per scanline in alphabetical channel order).
"""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2


def _attr(name: bytes, type_: bytes, value: bytes) -> bytes:
    return name + b"\0" + type_ + b"\0" + struct.pack("<i", len(value)) + value


def _channel_list(names, pixel_type: int) -> bytes:
    out = b""
    for nm in names:
        out += nm.encode() + b"\0"
        out += struct.pack("<i", pixel_type)
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\0"


def write_exr(path: str, img: np.ndarray, channel_names=None,
              half: bool = False) -> None:
    """Write (H, W) or (H, W, C) float data as an uncompressed EXR.

    Default channel names: Y for 1, RGB for 3, RGBA for 4, else c0..cN.
    ``half=True`` stores float16 (half) pixels like the reference's default
    Bitmap mode; otherwise full float32.
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 3: ["R", "G", "B"],
                         4: ["R", "G", "B", "A"]}.get(
            c, [f"c{i}" for i in range(c)])
    if len(channel_names) != c:
        raise ValueError("channel_names length mismatch")

    # EXR stores channels per scanline in alphabetical order
    order = sorted(range(c), key=lambda i: channel_names[i])
    names_sorted = [channel_names[i] for i in order]
    ptype = _PIXELTYPE_HALF if half else _PIXELTYPE_FLOAT
    dtype = np.float16 if half else np.float32

    header = b""
    header += _attr(b"channels", b"chlist", _channel_list(names_sorted, ptype))
    header += _attr(b"compression", b"compression", struct.pack("<B", 0))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", struct.pack("<B", 0))
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    bpc = 2 if half else 4
    line_bytes = w * c * bpc
    block_bytes = 8 + line_bytes
    preamble = struct.pack("<iI", _MAGIC, 2)
    table_pos = len(preamble) + len(header)
    data_pos = table_pos + 8 * h

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        for y in range(h):
            f.write(struct.pack("<Q", data_pos + y * block_bytes))
        payload = img[:, :, order].astype(dtype)
        for y in range(h):
            f.write(struct.pack("<ii", y, line_bytes))
            # per-scanline: each channel's row contiguously
            f.write(payload[y].T.tobytes())


def _read_attrs(buf: bytes, pos: int):
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\0", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\0", pos)
        type_ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos:pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path: str):
    """Read an uncompressed scanline EXR (HALF or FLOAT channels).

    Returns (img (H, W, C) float32, channel_names) with channels in the
    file's (alphabetical) order."""
    buf = open(path, "rb").read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    attrs, pos = _read_attrs(buf, 8)

    comp = attrs["compression"][1][0]
    if comp != 0:
        raise NotImplementedError(f"compressed EXR (mode {comp}) not "
                                  "supported by this minimal reader")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    chan = attrs["channels"][1]
    names, types = [], []
    cpos = 0
    while chan[cpos] != 0:
        e = chan.index(b"\0", cpos)
        names.append(chan[cpos:e].decode())
        (pt,) = struct.unpack_from("<i", chan, e + 1)
        types.append(pt)
        cpos = e + 1 + 16
    c = len(names)

    pos += 8 * h  # skip offset table
    out = np.empty((h, w, c), np.float32)
    for yy in range(h):
        y, nbytes = struct.unpack_from("<ii", buf, pos)
        pos += 8
        off = 0
        for ci in range(c):
            if types[ci] == _PIXELTYPE_HALF:
                row = np.frombuffer(buf, np.float16, w, pos + off)
                off += 2 * w
            elif types[ci] == _PIXELTYPE_FLOAT:
                row = np.frombuffer(buf, np.float32, w, pos + off)
                off += 4 * w
            else:
                raise NotImplementedError("uint EXR channels not supported")
            out[y - y0, :, ci] = row
        pos += nbytes
    return out, names
