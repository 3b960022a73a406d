"""Flow file codecs: KITTI 16-bit PNG and Middlebury .flo.

Copy of ``upflow_pytorch_tpu/data/flow_io.py`` (numpy and zlib only), the
port of the reference's ``img_func.read_png_flow``
(``dataset/kitti_dataset.py:130-149``) and ``tools.write_flow_png`` /
``read_flo`` / ``write_flo`` (``utils/tools.py:1482-1632``).  The files
it writes are byte for byte the JAX package's.

KITTI flow PNG: RGB uint16, R = u*64 + 2^15, G = v*64 + 2^15, B = valid.
Returned arrays are HWC (flow (H, W, 2) float32, mask (H, W, 1) uint8).

The PNG codec is pure numpy + zlib: 8/16-bit, grayscale/RGB/RGBA,
non-interlaced.  Rows filtered by Sub, Average or Paeth are unfiltered
pixel by pixel in Python (seconds per KITTI frame); ``data/native.py``
decodes them in C++.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader: 8/16-bit, grayscale/RGB/RGBA, non-interlaced.

    Returns (H, W, C) uint8 or uint16.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file: %s" % path)
    pos = 8
    idat = b""
    width = height = bitdepth = colortype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk)
            if interlace != 0:
                raise ValueError("interlaced PNG not supported: %s" % path)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[colortype]
    if bitdepth not in (8, 16):
        raise ValueError("unsupported bit depth %d: %s" % (bitdepth, path))
    bpp = nch * (bitdepth // 8)
    raw = zlib.decompress(idat)
    stride = width * bpp
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)], np.uint8).copy()
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev).astype(np.uint8)
        elif ftype in (1, 3, 4):  # sub / average / paeth need sequential scan
            cur = line
            left = np.zeros(bpp, np.uint8)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                if ftype == 1:
                    cur[x:x + bpp] = cur[x:x + bpp] + left
                elif ftype == 3:
                    cur[x:x + bpp] = cur[x:x + bpp] + (
                        (left.astype(np.int32) + up.astype(np.int32)) // 2
                    ).astype(np.uint8)
                else:
                    ul = prev[x - bpp:x] if x else np.zeros(bpp, np.uint8)
                    cur[x:x + bpp] = cur[x:x + bpp] + _paeth(left, up, ul)
                left = cur[x:x + bpp]
        else:
            raise ValueError("bad PNG filter %d" % ftype)
        out[y] = cur
        prev = cur
    if bitdepth == 16:
        img = out.reshape(height, width, nch, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
        return img
    return out.reshape(height, width, nch)


def write_png(path: str, img: np.ndarray, compression: int = 3) -> None:
    """Minimal PNG writer: (H, W, C) uint8 or uint16, C in {1, 3}."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else img.shape[2]
    colortype = {1: 0, 3: 2}[nch]
    bitdepth = 16 if img.dtype == np.uint16 else 8
    if bitdepth == 16:
        payload = img.astype(">u2").tobytes()
        stride = w * nch * 2
    else:
        payload = img.astype(np.uint8).tobytes()
        stride = w * nch
    raw = b"".join(b"\x00" + payload[y * stride:(y + 1) * stride]
                   for y in range(h))

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, colortype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, compression)))
        f.write(chunk(b"IEND", b""))


def read_flow_png(path: str):
    """KITTI flow PNG -> (flow (H,W,2) float32, valid (H,W,1) uint8)."""
    gt = read_png(path)
    if gt.dtype != np.uint16 or gt.shape[2] != 3:
        raise ValueError("expected 16-bit RGB flow PNG: %s" % path)
    flow = (gt[:, :, 0:2].astype(np.float64) - 2 ** 15) / 64.0
    mask = gt[:, :, 2:3].astype(np.uint8)
    return flow.astype(np.float32), mask


def write_flow_png(path: str, flow: np.ndarray, mask: np.ndarray | None = None
                   ) -> None:
    """(H, W, 2) float flow (+ optional valid mask) -> KITTI 16-bit PNG."""
    h, w = flow.shape[:2]
    if mask is None:
        mask = np.ones((h, w), np.uint16)
    out = np.stack([
        np.clip(flow[..., 0] * 64.0 + 2 ** 15, 0.0, 65535.0).astype(np.uint16),
        np.clip(flow[..., 1] * 64.0 + 2 ** 15, 0.0, 65535.0).astype(np.uint16),
        np.asarray(mask).reshape(h, w).astype(np.uint16),
    ], axis=-1)
    write_png(path, out)


_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        if magic != np.float32(_FLO_MAGIC):
            raise ValueError("invalid .flo magic in %s" % path)
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
