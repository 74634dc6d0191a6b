"""RecordIO: MXNet's record-packed binary container, the port of
``mxtpu/recordio.py`` (reference ``python/mxnet/recordio.py`` and
dmlc-core's ``recordio.h``). Host code, copied: files written by either
package read back in the other, byte for byte.

Format per record: ``uint32 kMagic=0xced7230a``, ``uint32 lrecord``
(cflag in the top 3 bits, length in the low 29), payload, zero-padding
to a 4-byte boundary. Indexed variant keeps a text ``.idx`` of
``key\\tbyte_offset`` lines. ``pack_img``/``unpack_img`` go through
the port's ``mx.image`` codec.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "RecordIOSplit",
           "IRHeader", "pack", "unpack", "pack_img", "unpack_img"]

_KMAGIC = 0xced7230a


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference ``MXRecordIO``)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.pid: Optional[int] = None
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError(f"Invalid flag {self.flag}")
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False
            self.pid = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if not self.is_open:
            if self.flag == "w":
                # re-opening 'wb' would truncate what was already
                # written; continue the stream instead
                self.record = open(self.uri, "ab")
                self.writable = True
                if hasattr(self, "idx_path"):
                    self.fidx = open(self.idx_path, "a")
                self.pid = os.getpid()
                self.is_open = True
            else:
                self.open()

    def _check_pid(self, allow_reset: bool = True):
        # after fork (DataLoader workers) the fd must be reopened — but
        # NEVER for a writer: reopening 'wb' would truncate everything
        # written so far (reference guards identically)
        if self.pid != os.getpid():
            if not allow_reset:
                raise MXNetError(
                    "RecordIO writer used across a fork; writing from a "
                    "forked process would truncate the file")
            self.reset()

    def _write_chunk(self, buf: bytes, cflag: int):
        length = len(buf)
        self.record.write(struct.pack("<II", _KMAGIC,
                                      (cflag << 29) | length))
        self.record.write(buf)
        pad = (-length) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def write(self, buf: bytes):
        assert self.writable
        self._check_pid(allow_reset=False)
        if len(buf) >= (1 << 29):      # reject BEFORE any bytes hit disk
            raise MXNetError("record too large for RecordIO (>512MB)")
        # dmlc escaping: a payload containing kMagic at a 4-byte-aligned
        # offset (payloads start file-aligned, so in-payload alignment ==
        # file alignment) would fool boundary-scanning readers
        # (InputSplit/RecordIOSplitter). Split at those magics into
        # multi-part chunks (cflag 1=first, 2=middle, 3=last); read()
        # re-joins by re-inserting the magic bytes.
        magic = struct.pack("<I", _KMAGIC)
        parts = []
        start = 0
        i = buf.find(magic)
        while i != -1:
            if i % 4 == 0:             # only aligned hits need escaping
                parts.append(buf[start:i])
                start = i + 4
                i = buf.find(magic, start)
            else:
                i = buf.find(magic, i + 1)
        parts.append(buf[start:])
        if len(parts) == 1:
            self._write_chunk(buf, 0)
        else:
            last = len(parts) - 1
            for j, p in enumerate(parts):
                self._write_chunk(p, 1 if j == 0 else (3 if j == last
                                                       else 2))

    def _read_chunk(self):
        header = self.record.read(8)
        if len(header) < 8:
            return None, 0
        magic, lrec = struct.unpack("<II", header)
        if magic != _KMAGIC:
            raise MXNetError(f"RecordIO magic mismatch ({magic:#x})")
        cflag = lrec >> 29
        length = lrec & ((1 << 29) - 1)
        buf = self.record.read(length)
        pad = (-length) % 4
        if pad:
            self.record.read(pad)
        return buf, cflag

    def read(self) -> Optional[bytes]:
        assert not self.writable
        self._check_pid()
        buf, cflag = self._read_chunk()
        if buf is None:
            return None
        if cflag == 0:          # complete record
            return buf
        # dmlc multi-part record (payload contained the aligned magic):
        # cflag 1 = first chunk, 2 = middle, 3 = last; chunks are joined
        # by re-inserting the magic bytes that were split out
        if cflag != 1:
            raise MXNetError(f"RecordIO stream corrupt (cflag {cflag} "
                             "without a start chunk)")
        parts = [buf]
        while True:
            nxt, cf = self._read_chunk()
            if nxt is None:
                raise MXNetError("RecordIO truncated multi-part record")
            parts.append(nxt)
            if cf == 3:
                break
            if cf != 2:
                raise MXNetError(
                    f"RecordIO stream corrupt (cflag {cf} inside a "
                    "multi-part record)")
        return struct.pack("<I", _KMAGIC).join(parts)

    def tell(self) -> int:
        return self.record.tell()

    def seek(self, pos: int):
        assert not self.writable
        self._check_pid()
        self.record.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a ``.idx`` sidecar (reference
    ``MXIndexedRecordIO``)."""

    def __init__(self, idx_path: str, uri: str, flag: str,
                 key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys: List = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
            self.fidx = None
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.is_open and self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def read_idx(self, idx) -> bytes:
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{idx}\t{pos}\n")
        self.idx[idx] = pos
        self.keys.append(idx)


# ---------------------------------------------------------------------------
# image-record header (reference IRHeader in python/mxnet/recordio.py)
# ---------------------------------------------------------------------------
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a header + payload into a record body (reference ``pack``).
    ``header.flag > 0`` means the label is a float array of that length
    stored right after the fixed header."""
    label = header.label
    if isinstance(label, numbers.Number):
        header = header._replace(flag=0)
        ext = b""
    else:
        label = np.asarray(label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        ext = label.tobytes()
    return struct.pack(_IR_FORMAT, int(header.flag), float(header.label),
                       int(header.id), int(header.id2)) + ext + s


def unpack(s: bytes):
    """Unpack a record body → (IRHeader, payload bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header: IRHeader, img, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 image and pack (reference ``pack_img``)."""
    from .image import imencode
    return pack(header, imencode(img, img_fmt=img_fmt, quality=quality))


def unpack_img(s: bytes, iscolor=-1):
    """Unpack a record body → (IRHeader, decoded HWC numpy image).
    ``iscolor=0`` decodes grayscale (H, W, 1), like the reference's
    cv2.IMREAD_GRAYSCALE flag."""
    from .image import imdecode
    header, buf = unpack(s)
    return header, imdecode(buf, flag=0 if iscolor == 0 else 1,
                            to_rgb=True, as_numpy=True)


# ---------------------------------------------------------------------------
# InputSplit (reference 3rdparty/dmlc-core input_split.cc +
# recordio_split.cc): partition one .rec file into byte ranges, each
# part boundary-scanning forward to the next aligned record header —
# the mechanism dist workers use to shard a dataset file without an
# index.
# ---------------------------------------------------------------------------
def _scan_to_record(f, start: int, file_size: int) -> int:
    """First aligned kMagic header at or after ``start`` that parses as
    a plausible record START (cflag 0 = whole record or 1 = first
    chunk). Continuation chunks (cflag 2/3) are skipped — that's the
    reason the cflag exists: a split boundary landing inside a
    multi-part record must not start a part mid-record."""
    pos = start + ((-start) % 4)
    f.seek(pos)
    while pos + 8 <= file_size:
        hdr = f.read(8)
        if len(hdr) < 8:
            return file_size
        magic, lrec = struct.unpack("<II", hdr)
        cflag = lrec >> 29
        length = lrec & ((1 << 29) - 1)
        if magic == _KMAGIC and cflag in (0, 1) and \
                pos + 8 + length <= file_size:
            return pos
        pos += 4
        f.seek(pos)
    return file_size


class RecordIOSplit:
    """Iterate the records of ONE part of an evenly byte-partitioned
    RecordIO file (reference dmlc ``InputSplit::Create(uri, part,
    nsplit, "recordio")``). A record belongs to the part its header
    byte falls in, so every record is yielded by exactly one part."""

    def __init__(self, uri: str, part: int, num_parts: int):
        if not 0 <= part < num_parts:
            raise ValueError(f"part {part} not in [0, {num_parts})")
        self.uri = uri
        size = os.path.getsize(uri)
        lo = part * size // num_parts
        hi = (part + 1) * size // num_parts
        self._reader = MXRecordIO(uri, "r")
        f = self._reader.record
        self._start = _scan_to_record(f, lo, size) if lo else 0
        self._end = _scan_to_record(f, hi, size) if hi < size else size
        self._reader.seek(self._start)

    def __iter__(self):
        self._reader.seek(self._start)
        while self._reader.tell() < self._end:
            rec = self._reader.read()
            if rec is None:
                return
            yield rec

    def close(self):
        self._reader.close()
