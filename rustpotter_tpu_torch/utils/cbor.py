"""Minimal CBOR (RFC 8949) codec for the .rpw wakeword file format.

The reference serializes wakewords with ciborium + serde
(reference src/wakewords/wakeword_file.rs:10-42). Encoding conventions it
produces:
  - structs -> definite maps keyed by field name, in declaration order
  - f32 -> major 7, additional 26 (0xfa)
  - Vec<u8> -> array of unsigned ints (serde's default Vec<u8> behavior)
  - Option::None -> null (0xf6)
  - unit enum variants (ModelType) -> text string of the variant name

A copy of `rustpotter_tpu.utils.cbor`: just enough CBOR to read and write
those files byte-compatibly, with no external dependency.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO


class CborError(ValueError):
    pass


# ---------------------------------------------------------------- decoding


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CborError("truncated CBOR input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def _read_uint(self, info: int) -> int:
        if info < 24:
            return info
        if info == 24:
            return self._take(1)[0]
        if info == 25:
            return struct.unpack(">H", self._take(2))[0]
        if info == 26:
            return struct.unpack(">I", self._take(4))[0]
        if info == 27:
            return struct.unpack(">Q", self._take(8))[0]
        raise CborError(f"unsupported additional info {info}")

    def _until_break(self, item):
        items = []
        while self.pos < len(self.data) and self.data[self.pos] != 0xFF:
            items.append(item())
        self._take(1)
        return items

    def decode(self) -> Any:
        initial = self._take(1)[0]
        major, info = initial >> 5, initial & 0x1F
        if major == 0:  # unsigned int
            return self._read_uint(info)
        if major == 1:  # negative int
            return -1 - self._read_uint(info)
        if major == 2:  # byte string
            if info == 31:
                return b"".join(self._until_break(self.decode))
            return self._take(self._read_uint(info))
        if major == 3:  # text string
            if info == 31:
                return "".join(self._until_break(self.decode))
            return self._take(self._read_uint(info)).decode("utf-8")
        if major == 4:  # array
            if info == 31:
                return self._until_break(self.decode)
            return [self.decode() for _ in range(self._read_uint(info))]
        if major == 5:  # map
            if info == 31:
                return dict(self._until_break(lambda: (self.decode(), self.decode())))
            out = {}
            for _ in range(self._read_uint(info)):
                key = self.decode()
                out[key] = self.decode()
            return out
        if major == 6:  # tag: decode and ignore the tag
            self._read_uint(info)
            return self.decode()
        # major 7: simple / float
        if info == 20:
            return False
        if info == 21:
            return True
        if info in (22, 23):  # null, undefined
            return None
        if info == 25:
            return struct.unpack(">e", self._take(2))[0]
        if info == 26:
            return struct.unpack(">f", self._take(4))[0]
        if info == 27:
            return struct.unpack(">d", self._take(8))[0]
        raise CborError(f"unsupported simple value {info}")


def loads(data: bytes) -> Any:
    return _Decoder(data).decode()


def load(fp: BinaryIO) -> Any:
    return loads(fp.read())


# ---------------------------------------------------------------- encoding


class Float32(float):
    """Marker type: encode this float as CBOR float32 (like Rust f32)."""


def _encode_head(out: bytearray, major: int, value: int) -> None:
    mt = major << 5
    if value < 24:
        out.append(mt | value)
    elif value < 1 << 8:
        out.append(mt | 24)
        out.append(value)
    elif value < 1 << 16:
        out.append(mt | 25)
        out += struct.pack(">H", value)
    elif value < 1 << 32:
        out.append(mt | 26)
        out += struct.pack(">I", value)
    else:
        out.append(mt | 27)
        out += struct.pack(">Q", value)


def _encode(out: bytearray, value: Any, float32: bool) -> None:
    if value is None:
        out.append(0xF6)
    elif value is True:
        out.append(0xF5)
    elif value is False:
        out.append(0xF4)
    elif isinstance(value, Float32):
        out.append(0xFA)
        out += struct.pack(">f", float(value))
    elif isinstance(value, float):
        if float32:
            out.append(0xFA)
            out += struct.pack(">f", value)
        else:
            out.append(0xFB)
            out += struct.pack(">d", value)
    elif isinstance(value, int):
        if value >= 0:
            _encode_head(out, 0, value)
        else:
            _encode_head(out, 1, -1 - value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        _encode_head(out, 3, len(raw))
        out += raw
    elif isinstance(value, (bytes, bytearray)):
        _encode_head(out, 2, len(value))
        out += bytes(value)
    elif isinstance(value, (list, tuple)):
        _encode_head(out, 4, len(value))
        for item in value:
            _encode(out, item, float32)
    elif isinstance(value, dict):
        _encode_head(out, 5, len(value))
        for key, item in value.items():
            _encode(out, key, float32)
            _encode(out, item, float32)
    elif hasattr(value, "item") and callable(value.item):  # numpy scalar
        _encode(out, value.item(), float32)
    else:
        raise CborError(f"cannot encode {type(value)!r}")


def dumps(value: Any, float32: bool = True) -> bytes:
    """Encode to CBOR. With float32=True (default) all Python floats are
    written as CBOR float32, matching the reference's f32 fields."""
    out = bytearray()
    _encode(out, value, float32)
    return bytes(out)


def dump(value: Any, fp: BinaryIO, float32: bool = True) -> None:
    fp.write(dumps(value, float32))
