"""Low-level EBML primitives: variable-length ints, element headers, readers.

Format: RFC 8794 (EBML). Behavioral parity target: the vendored nestegg
parser (/root/reference/ext/nestegg/nestegg.c:630-946) — varint decode,
element id/size reading, and signed-vint semantics for EBML lacing — but
implemented as a fresh streaming reader, not a descriptor-table port.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

from easyav1.io.stream import Stream


class EBMLError(Exception):
    pass


class EOF(EBMLError):
    pass


#: Sentinel for "unknown size" elements (all value bits set in the vint).
UNKNOWN_SIZE = -1


class EBMLReader:
    """Buffered EBML reader over a Stream.

    Keeps an explicit byte position so parse state can be snapshotted and
    restored for error recovery (parity: ne_ctx_save/restore,
    nestegg.c:999-1026, used by nestegg_read_reset).
    """

    def __init__(self, stream: Stream):
        self.stream = stream

    # -- raw IO ------------------------------------------------------------

    def tell(self) -> int:
        return self.stream.tell()

    def seek(self, pos: int) -> None:
        self.stream.seek(pos, os.SEEK_SET)

    def read_bytes(self, n: int) -> bytes:
        data = self.stream.read(n)
        if len(data) != n:
            raise EOF(f"wanted {n} bytes, got {len(data)}")
        return data

    def read_byte(self) -> int:
        b = self.stream.read(1)
        if not b:
            raise EOF("eof at read_byte")
        return b[0]

    def at_eof(self) -> bool:
        pos = self.tell()
        b = self.stream.read(1)
        if not b:
            return True
        self.seek(pos)
        return False

    # -- vints -------------------------------------------------------------

    def read_id(self) -> int:
        """Element ID: vint with the marker bit KEPT (class A..D ids)."""
        first = self.read_byte()
        if first == 0:
            raise EBMLError("invalid element id (0x00)")
        length = 8 - first.bit_length()
        if length > 3:
            raise EBMLError(f"element id too long (first byte {first:#x})")
        value = first
        for _ in range(length):
            value = (value << 8) | self.read_byte()
        return value

    def read_vint(self) -> Tuple[int, int, int]:
        """Data-size vint. Returns (value, length_bytes, value_bit_count).

        The marker bit is stripped. value_bit_count lets callers detect the
        all-ones "unknown size" encoding.
        """
        first = self.read_byte()
        if first == 0:
            raise EBMLError("invalid vint (0x00 first byte)")
        extra = 8 - first.bit_length()
        mask = (1 << (7 - extra)) - 1
        value = first & mask
        for _ in range(extra):
            value = (value << 8) | self.read_byte()
        return value, extra + 1, 7 * (extra + 1)

    def read_size(self) -> int:
        """Element size; UNKNOWN_SIZE if the all-ones encoding was used."""
        value, _length, bits = self.read_vint()
        if value == (1 << bits) - 1:
            return UNKNOWN_SIZE
        return value

    def read_element_header(self) -> Tuple[int, int]:
        """Returns (element_id, size)."""
        return self.read_id(), self.read_size()

    # -- typed payloads ----------------------------------------------------

    def read_uint(self, size: int) -> int:
        if size > 8:
            raise EBMLError(f"uint too large ({size} bytes)")
        value = 0
        for b in self.read_bytes(size):
            value = (value << 8) | b
        return value

    def read_sint(self, size: int) -> int:
        value = self.read_uint(size)
        if size and value >= 1 << (8 * size - 1):
            value -= 1 << (8 * size)
        return value

    def read_float(self, size: int) -> float:
        if size == 0:
            return 0.0
        if size == 4:
            return struct.unpack(">f", self.read_bytes(4))[0]
        if size == 8:
            return struct.unpack(">d", self.read_bytes(8))[0]
        raise EBMLError(f"invalid float size {size}")

    def read_string(self, size: int) -> str:
        return self.read_bytes(size).rstrip(b"\x00").decode("utf-8", "replace")

    def skip(self, size: int) -> None:
        self.stream.seek(size, os.SEEK_CUR)


def read_block_vint(data: bytes, pos: int) -> Tuple[int, int]:
    """Unsigned vint from a byte buffer (track numbers inside Block payloads).

    Returns (value, new_pos)."""
    first = data[pos]
    if first == 0:
        raise EBMLError("invalid vint in block")
    extra = 8 - first.bit_length()
    mask = (1 << (7 - extra)) - 1
    value = first & mask
    for i in range(extra):
        value = (value << 8) | data[pos + 1 + i]
    return value, pos + 1 + extra


def read_block_svint(data: bytes, pos: int) -> Tuple[int, int]:
    """Signed vint (EBML lacing deltas): unsigned vint minus bias 2^(7n-1)-1."""
    first = data[pos]
    extra = 8 - first.bit_length()
    value, new_pos = read_block_vint(data, pos)
    bias = (1 << (7 * (extra + 1) - 1)) - 1
    return value - bias, new_pos


def encode_id(element_id: int) -> bytes:
    """Encode an element id (marker bit already included)."""
    n = (element_id.bit_length() + 7) // 8
    return element_id.to_bytes(n, "big")


def encode_vint(value: int, length: Optional[int] = None) -> bytes:
    """Encode a data-size vint, optionally forcing a byte length."""
    if length is None:
        length = 1
        while value >= (1 << (7 * length)) - 1 and length < 8:
            length += 1
    if value >= (1 << (7 * length)) - 1:
        raise EBMLError(f"value {value} does not fit in {length}-byte vint")
    out = value | (1 << (7 * length))
    return out.to_bytes(length, "big")


def encode_unknown_size(length: int = 8) -> bytes:
    return ((1 << (7 * length + 1)) - 1).to_bytes(length, "big")
