"""PNG decode and encode with the standard library's ``zlib`` and numpy:
``mx.image``'s PNG codec.

PNG is lossless, so decoded pixels equal those of any other decoder
(libpng, which the reference reaches through TensorFlow). Decode takes
every colour type, bit depths 1-16 and Adam7 interlacing, and returns
uint8: 16-bit samples keep their high byte, a palette is looked up,
alpha is dropped, grey is repeated for 3 channels and colour made grey
for 1 with libpng's ``png_set_rgb_to_gray`` weights for 0.299/0.587
(the reference's choice) and its roundings. Encode writes uint8 in one
IDAT with no row filter, so the bytes differ from libpng's while the
pixels are the same.
"""
from __future__ import annotations

import struct
import zlib

import numpy as onp

__all__ = ["is_png", "decode", "encode"]

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's fixed-point weights for png_set_rgb_to_gray(.., 0.299, 0.587)
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def is_png(buf: bytes) -> bool:
    return bytes(buf[:8]) == _SIG


def _unfilter(raw: memoryview, pos: int, rows: int, stride: int, bpp: int):
    """Undo the row filters of one (sub)image; returns (bytes, next pos)."""
    out = bytearray(rows * stride)
    prior = bytearray(stride)
    for y in range(rows):
        ftype = raw[pos]
        line = bytearray(raw[pos + 1:pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:                                      # Sub
            a = onp.frombuffer(bytes(line), onp.uint8).astype(onp.int64)
            if stride % bpp == 0:
                a = onp.cumsum(a.reshape(-1, bpp), axis=0).ravel()
            else:
                a = onp.cumsum(a)
            line = bytearray((a & 0xFF).astype(onp.uint8).tobytes())
        elif ftype == 2:                                    # Up
            line = bytearray(((onp.frombuffer(bytes(line), onp.uint8)
                               .astype(onp.uint16)
                               + onp.frombuffer(bytes(prior), onp.uint8))
                              & 0xFF).astype(onp.uint8).tobytes())
        elif ftype == 3:                                    # Average
            for i in range(stride):
                left = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((left + prior[i]) >> 1)) & 0xFF
        elif ftype == 4:                                    # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prior[i]
                c = prior[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else c)
                line[i] = (line[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[y * stride:(y + 1) * stride] = line
        prior = line
    return out, pos


def _samples(data: bytes, rows: int, cols: int, spp: int, depth: int):
    """Unfiltered bytes → (rows, cols, spp) integer samples."""
    a = onp.frombuffer(bytes(data), onp.uint8)
    if depth == 16:
        return a.view(">u2").reshape(rows, cols, spp).astype(onp.uint16)
    if depth == 8:
        return a.reshape(rows, cols, spp)
    stride = (cols * spp * depth + 7) // 8
    bits = onp.unpackbits(a.reshape(rows, stride), axis=1)
    bits = bits[:, :cols * spp * depth].reshape(rows, cols * spp, depth)
    weights = (1 << onp.arange(depth - 1, -1, -1)).astype(onp.uint8)
    return (bits * weights).sum(axis=2).astype(onp.uint8).reshape(
        rows, cols, spp)


def decode(buf: bytes, channels: int = 3) -> onp.ndarray:
    """PNG bytes → (H, W, channels) uint8, ``channels`` 1 or 3."""
    buf = memoryview(bytes(buf))
    if bytes(buf[:8]) != _SIG:
        raise ValueError("not a PNG")
    pos, idat, plte = 8, [], None
    ihdr = None
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = bytes(buf[pos + 8:pos + 8 + n])
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = onp.frombuffer(body, onp.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not defined")
    spp = _CHANNELS[ctype]
    bpp = max(1, spp * depth // 8)
    raw = memoryview(zlib.decompress(b"".join(idat)))
    if interlace:
        img = onp.zeros((h, w, spp), onp.uint16 if depth == 16
                        else onp.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            cols = (w - x0 + dx - 1) // dx
            rows = (h - y0 + dy - 1) // dy
            if cols <= 0 or rows <= 0:
                continue
            stride = (cols * spp * depth + 7) // 8
            data, pos = _unfilter(raw, pos, rows, stride, bpp)
            img[y0::dy, x0::dx] = _samples(data, rows, cols, spp, depth)
    else:
        stride = (w * spp * depth + 7) // 8
        data, _ = _unfilter(raw, 0, h, stride, bpp)
        img = _samples(data, h, w, spp, depth)
    if depth == 16 and channels == 1 and ctype in (2, 6):
        # libpng makes colour grey before it strips to 8 bits, rounding
        # at 16 bits (and truncating at 8)
        r, g, b = (img[..., i].astype(onp.uint64) for i in range(3))
        gray = (_GRAY_R * r + _GRAY_G * g + _GRAY_B * b + 16384) >> 15
        return (gray >> 8).astype(onp.uint8)[..., None]
    if depth == 16:
        img = (img >> 8).astype(onp.uint8)
    elif depth < 8 and ctype == 0:         # scale grey to 0..255
        img = (img.astype(onp.uint16) * (255 // ((1 << depth) - 1))
               ).astype(onp.uint8)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        img = plte[img[..., 0]]
    elif ctype in (4, 6):
        img = img[..., :-1]                # alpha is dropped
    if channels == 3:
        return onp.ascontiguousarray(onp.repeat(img, 3, axis=2)
                                     if img.shape[2] == 1 else img)
    if channels == 1:
        if img.shape[2] == 1:
            return onp.ascontiguousarray(img)
        r, g, b = (img[..., i].astype(onp.uint32) for i in range(3))
        return ((_GRAY_R * r + _GRAY_G * g + _GRAY_B * b) >> 15
                ).astype(onp.uint8)[..., None]
    raise ValueError(f"channels must be 1 or 3, not {channels}")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode(img: onp.ndarray) -> bytes:
    """(H, W[, C]) uint8, C in 1-4 → PNG bytes."""
    img = onp.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4) or \
            img.dtype != onp.uint8:
        raise ValueError(f"PNG encodes uint8 HWC images of 1-4 channels, "
                         f"not {img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = onp.ascontiguousarray(img).reshape(h, -1)
    raw = onp.concatenate([onp.zeros((h, 1), onp.uint8), rows], axis=1)
    return (_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          {1: 0, 2: 4, 3: 2, 4: 6}[c],
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
