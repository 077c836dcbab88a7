"""Vorbis codebooks: header parse, canonical Huffman assignment, scalar and
VQ decode (Vorbis I spec §3). Decode uses a one-level lookup table for
codes up to LUT_BITS plus a bit-by-bit fallback for longer codes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from easyav1.audio.vorbis.bitreader import (
    BitReader, EndOfPacket, float32_unpack, ilog, lookup1_values,
)


class VorbisError(Exception):
    pass


LUT_BITS = 11


def assign_codewords(lengths: List[int]) -> List[Optional[int]]:
    """Canonical Vorbis codeword assignment (spec §3.2.1): each used entry,
    in order, takes the lowest-valued available codeword of its length.
    Returns codeword values (first-read bit = MSB) or None for unused.
    Raises VorbisError on over/under-specified trees (underspecified is
    allowed for single-entry books, handled by the caller)."""
    import bisect

    used = [l for l in lengths if l > 0]
    if not used:
        return [None] * len(lengths)
    codes: List[Optional[int]] = [None] * len(lengths)
    # Free subtrees as (left_aligned_value, depth), sorted by value.
    free: List[tuple] = [(0, 0)]  # the whole tree
    for i, l in enumerate(lengths):
        if l <= 0:
            continue
        # lowest-valued free subtree shallow enough to host an l-bit code
        pick = None
        for j, (value, depth) in enumerate(free):
            if depth <= l:
                pick = j
                break
        if pick is None:
            raise VorbisError("overspecified huffman tree")
        value, depth = free.pop(pick)
        codes[i] = value >> (32 - l) if l < 32 else value
        # descending the 0-branch from `depth` to `l` frees each 1-sibling
        for d in range(depth + 1, l + 1):
            bisect.insort(free, (value | (1 << (32 - d)), d))
    return codes


class Codebook:
    def __init__(self, br: BitReader, index: int):
        if br.read(24) != 0x564342:  # 'BCV'
            raise VorbisError(f"codebook {index}: bad sync")
        self.dimensions = br.read(16)
        self.entries = br.read(24)
        lengths = [0] * self.entries
        ordered = br.read1()
        if not ordered:
            sparse = br.read1()
            for i in range(self.entries):
                if sparse:
                    if br.read1():
                        lengths[i] = br.read(5) + 1
                else:
                    lengths[i] = br.read(5) + 1
        else:
            current_length = br.read(5) + 1
            i = 0
            while i < self.entries:
                number = br.read(ilog(self.entries - i))
                for j in range(i, i + number):
                    lengths[j] = current_length
                i += number
                current_length += 1
                if i > self.entries:
                    raise VorbisError("ordered codebook overflow")
        self.lengths = lengths
        self.used_entries = sum(1 for l in lengths if l > 0)

        # Huffman decode structures
        self._single_entry: Optional[int] = None
        if self.used_entries == 1:
            # Single-entry codebook: decoder reads `length` bits, returns
            # the entry regardless (libvorbis behavior).
            self._single_entry = next(i for i, l in enumerate(lengths) if l)
            self._single_len = lengths[self._single_entry]
        elif self.used_entries > 0:
            codes = assign_codewords(lengths)
            self._build_lut(codes)

        # Lookup (VQ) table
        self.lookup_type = br.read(4)
        self.vectors: Optional[np.ndarray] = None
        if self.lookup_type in (1, 2):
            minimum = float32_unpack(br.read(32))
            delta = float32_unpack(br.read(32))
            value_bits = br.read(4) + 1
            sequence_p = br.read1()
            if self.lookup_type == 1:
                lookup_values = lookup1_values(self.entries, self.dimensions)
            else:
                lookup_values = self.entries * self.dimensions
            mult = np.array([br.read(value_bits) for _ in range(lookup_values)],
                            dtype=np.float64)
            # Precompute the entry -> vector table (float32, matching
            # libvorbis' float math).
            dims = self.dimensions
            vecs = np.zeros((self.entries, dims), dtype=np.float32)
            if self.lookup_type == 1:
                idx = np.arange(self.entries, dtype=np.int64)
                last = np.zeros(self.entries, dtype=np.float32)
                divisor = 1
                for d in range(dims):
                    offset = (idx // divisor) % lookup_values
                    val = (mult[offset] * delta + minimum).astype(np.float32) + last
                    vecs[:, d] = val
                    if sequence_p:
                        last = val
                    divisor *= lookup_values
            else:
                raw = (mult.reshape(self.entries, dims) * delta + minimum
                       ).astype(np.float32)
                if sequence_p:
                    raw = np.cumsum(raw, axis=1, dtype=np.float32)
                vecs = raw
            self.vectors = vecs
        elif self.lookup_type != 0:
            raise VorbisError(f"bad lookup type {self.lookup_type}")

    def _build_lut(self, codes: List[Optional[int]]) -> None:
        lut = np.zeros(1 << LUT_BITS, dtype=np.int32)
        lut_len = np.zeros(1 << LUT_BITS, dtype=np.int8)
        all_codes = {}
        for entry, (code, l) in enumerate(zip(codes, self.lengths)):
            if code is None:
                continue
            all_codes[(l, code)] = entry
            # stream-order bits: first-read bit is MSB of `code`; the
            # peeked accumulator has first-read bit as its LSB -> reverse.
            rev = int(f"{code:0{l}b}"[::-1], 2)
            if l <= LUT_BITS:
                step = 1 << l
                lut[rev::step] = entry
                lut_len[rev::step] = l
        self._lut = lut
        self._lut_len = lut_len
        self._all_codes = all_codes

    # -- decode ------------------------------------------------------------

    def decode_scalar(self, br: BitReader) -> int:
        if self._single_entry is not None:
            br.read(self._single_len)
            return self._single_entry
        # fast path: peek LUT_BITS
        acc = br._acc
        n = br._nbits
        data, pos, ln = br._data, br._pos, br._len
        while n < LUT_BITS and pos < ln:
            acc |= data[pos] << n
            pos += 1
            n += 8
        idx = acc & ((1 << LUT_BITS) - 1)
        l = int(self._lut_len[idx])
        if l > 0 and l <= n:
            br._acc = acc >> l
            br._nbits = n - l
            br._pos = pos
            return int(self._lut[idx])
        # slow path: bit-by-bit (long codes or end-of-packet territory)
        code = 0
        length = 0
        for _ in range(32):
            code = (code << 1) | br.read1()
            length += 1
            entry = self._all_codes.get((length, code))
            if entry is not None:
                return entry
        raise VorbisError("huffman decode failed")

    def decode_vector(self, br: BitReader) -> np.ndarray:
        if self.vectors is None:
            raise VorbisError("scalar codebook used for VQ decode")
        return self.vectors[self.decode_scalar(br)]
