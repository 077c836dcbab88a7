"""Vorbis header parsing: identification + setup (Vorbis I spec §4.2).

Comment headers are accepted but ignored (easyav1 ignores them too —
it feeds all 3 headers to vorbis_synthesis_headerin, easyav1.c:1448-1470).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from easyav1.audio.vorbis.bitreader import BitReader, ilog
from easyav1.audio.vorbis.codebook import Codebook, VorbisError


@dataclasses.dataclass
class FloorConfig0:
    order: int
    rate: int
    bark_map_size: int
    amplitude_bits: int
    amplitude_offset: int
    book_list: List[int]


@dataclasses.dataclass
class FloorConfig1:
    partition_class_list: List[int]
    class_dimensions: List[int]
    class_subclasses: List[int]
    class_masterbooks: List[int]
    subclass_books: List[List[int]]
    multiplier: int
    x_list: List[int]
    # Derived:
    sorted_index: List[int] = dataclasses.field(default_factory=list)
    neighbors: List[tuple] = dataclasses.field(default_factory=list)
    range: int = 0

    def finish(self):
        self.range = [256, 128, 86, 64][self.multiplier - 1]
        # For each post i >= 2: low/high neighbor indices (spec §9.2.4):
        # greatest X below / least X above among positions 0..i-1.
        n = len(self.x_list)
        self.neighbors = [(0, 0)] * n
        for i in range(2, n):
            low = 0
            high = 1
            for j in range(i):
                if self.x_list[low] < self.x_list[j] < self.x_list[i]:
                    low = j
                if self.x_list[i] < self.x_list[j] < self.x_list[high]:
                    high = j
            self.neighbors[i] = (low, high)
        self.sorted_index = sorted(range(n), key=lambda k: self.x_list[k])


@dataclasses.dataclass
class ResidueConfig:
    type: int
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    cascade: List[int]
    books: List[List[int]]  # [class][pass] -> book index or -1


@dataclasses.dataclass
class MappingConfig:
    submaps: int
    coupling_steps: int
    magnitude: List[int]
    angle: List[int]
    mux: List[int]
    submap_floor: List[int]
    submap_residue: List[int]


@dataclasses.dataclass
class ModeConfig:
    blockflag: int
    mapping: int


class VorbisInfo:
    """Parsed stream configuration (the decoder's static state)."""

    def __init__(self):
        self.channels = 0
        self.sample_rate = 0
        self.blocksize0 = 0
        self.blocksize1 = 0
        self.codebooks: List[Codebook] = []
        self.floor_types: List[int] = []
        self.floor_configs: List[object] = []
        self.residues: List[ResidueConfig] = []
        self.mappings: List[MappingConfig] = []
        self.modes: List[ModeConfig] = []

    # ------------------------------------------------------------------

    def parse_ident(self, packet: bytes) -> None:
        br = _header_reader(packet, 1)
        version = br.read(32)
        if version != 0:
            raise VorbisError(f"unsupported vorbis version {version}")
        self.channels = br.read(8)
        self.sample_rate = br.read(32)
        br.read(32)  # bitrate_maximum
        br.read(32)  # bitrate_nominal
        br.read(32)  # bitrate_minimum
        self.blocksize0 = 1 << br.read(4)
        self.blocksize1 = 1 << br.read(4)
        if not (64 <= self.blocksize0 <= 8192) or not (64 <= self.blocksize1 <= 8192):
            raise VorbisError("invalid blocksizes")
        if self.blocksize0 > self.blocksize1:
            raise VorbisError("blocksize0 > blocksize1")
        if self.channels == 0 or self.sample_rate == 0:
            raise VorbisError("bad channels/rate")
        if not br.read1():
            raise VorbisError("ident framing bit unset")

    def parse_setup(self, packet: bytes) -> None:
        br = _header_reader(packet, 5)
        # Codebooks
        count = br.read(8) + 1
        self.codebooks = [Codebook(br, i) for i in range(count)]
        # Time domain transforms (placeholders, must be 0)
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise VorbisError("nonzero time transform")
        # Floors
        for _ in range(br.read(6) + 1):
            ftype = br.read(16)
            self.floor_types.append(ftype)
            if ftype == 0:
                self.floor_configs.append(self._parse_floor0(br))
            elif ftype == 1:
                self.floor_configs.append(self._parse_floor1(br))
            else:
                raise VorbisError(f"bad floor type {ftype}")
        # Residues
        for _ in range(br.read(6) + 1):
            rtype = br.read(16)
            if rtype > 2:
                raise VorbisError(f"bad residue type {rtype}")
            self.residues.append(self._parse_residue(br, rtype))
        # Mappings
        for _ in range(br.read(6) + 1):
            mtype = br.read(16)
            if mtype != 0:
                raise VorbisError(f"bad mapping type {mtype}")
            self.mappings.append(self._parse_mapping(br))
        # Modes
        for _ in range(br.read(6) + 1):
            blockflag = br.read1()
            if br.read(16) != 0 or br.read(16) != 0:
                raise VorbisError("nonzero mode window/transform type")
            mapping = br.read(8)
            if mapping >= len(self.mappings):
                raise VorbisError("mode mapping out of range")
            self.modes.append(ModeConfig(blockflag, mapping))
        if not br.read1():
            raise VorbisError("setup framing bit unset")

    # ------------------------------------------------------------------

    def _parse_floor0(self, br: BitReader) -> FloorConfig0:
        order = br.read(8)
        rate = br.read(16)
        bark_map_size = br.read(16)
        amplitude_bits = br.read(6)
        amplitude_offset = br.read(8)
        num_books = br.read(4) + 1
        books = [br.read(8) for _ in range(num_books)]
        for b in books:
            if b >= len(self.codebooks):
                raise VorbisError("floor0 book out of range")
        return FloorConfig0(order, rate, bark_map_size, amplitude_bits,
                            amplitude_offset, books)

    def _parse_floor1(self, br: BitReader) -> FloorConfig1:
        partitions = br.read(5)
        partition_class_list = [br.read(4) for _ in range(partitions)]
        maximum_class = max(partition_class_list) if partitions else -1
        class_dimensions = []
        class_subclasses = []
        class_masterbooks = []
        subclass_books = []
        for _ in range(maximum_class + 1):
            class_dimensions.append(br.read(3) + 1)
            subclasses = br.read(2)
            class_subclasses.append(subclasses)
            if subclasses:
                master = br.read(8)
                if master >= len(self.codebooks):
                    raise VorbisError("floor1 masterbook out of range")
                class_masterbooks.append(master)
            else:
                class_masterbooks.append(-1)
            books = []
            for _ in range(1 << subclasses):
                b = br.read(8) - 1
                if b >= len(self.codebooks):
                    raise VorbisError("floor1 subclass book out of range")
                books.append(b)
            subclass_books.append(books)
        multiplier = br.read(2) + 1
        rangebits = br.read(4)
        x_list = [0, 1 << rangebits]
        for i in range(partitions):
            cls = partition_class_list[i]
            for _ in range(class_dimensions[cls]):
                x_list.append(br.read(rangebits))
        if len(x_list) > 65:
            raise VorbisError("floor1 too many X values")
        if len(set(x_list)) != len(x_list):
            raise VorbisError("floor1 duplicate X values")
        cfg = FloorConfig1(partition_class_list, class_dimensions,
                           class_subclasses, class_masterbooks,
                           subclass_books, multiplier, x_list)
        cfg.finish()
        return cfg

    def _parse_residue(self, br: BitReader, rtype: int) -> ResidueConfig:
        begin = br.read(24)
        end = br.read(24)
        partition_size = br.read(24) + 1
        classifications = br.read(6) + 1
        classbook = br.read(8)
        if classbook >= len(self.codebooks):
            raise VorbisError("residue classbook out of range")
        cascade = []
        for _ in range(classifications):
            high_bits = 0
            low_bits = br.read(3)
            if br.read1():
                high_bits = br.read(5)
            cascade.append((high_bits << 3) | low_bits)
        books: List[List[int]] = []
        for c in range(classifications):
            row = []
            for p in range(8):
                if cascade[c] & (1 << p):
                    b = br.read(8)
                    if b >= len(self.codebooks):
                        raise VorbisError("residue book out of range")
                    if self.codebooks[b].vectors is None:
                        raise VorbisError("residue book has no lookup values")
                    row.append(b)
                else:
                    row.append(-1)
            books.append(row)
        return ResidueConfig(rtype, begin, end, partition_size,
                             classifications, classbook, cascade, books)

    def _parse_mapping(self, br: BitReader) -> MappingConfig:
        ch = self.channels
        submaps = br.read(4) + 1 if br.read1() else 1
        coupling_steps = 0
        magnitude: List[int] = []
        angle: List[int] = []
        if br.read1():
            coupling_steps = br.read(8) + 1
            for _ in range(coupling_steps):
                m = br.read(ilog(ch - 1))
                a = br.read(ilog(ch - 1))
                if m == a or m >= ch or a >= ch:
                    raise VorbisError("bad coupling channels")
                magnitude.append(m)
                angle.append(a)
        if br.read(2) != 0:
            raise VorbisError("mapping reserved bits set")
        if submaps > 1:
            mux = [br.read(4) for _ in range(ch)]
            if any(m >= submaps for m in mux):
                raise VorbisError("mux out of range")
        else:
            mux = [0] * ch
        submap_floor = []
        submap_residue = []
        for _ in range(submaps):
            br.read(8)  # unused time config
            f = br.read(8)
            r = br.read(8)
            if f >= len(self.floor_configs) or r >= len(self.residues):
                raise VorbisError("submap floor/residue out of range")
            submap_floor.append(f)
            submap_residue.append(r)
        return MappingConfig(submaps, coupling_steps, magnitude, angle, mux,
                             submap_floor, submap_residue)


def _header_reader(packet: bytes, expected_type: int) -> BitReader:
    if len(packet) < 7 or packet[0] != expected_type or packet[1:7] != b"vorbis":
        raise VorbisError(f"bad header packet (expected type {expected_type})")
    return BitReader(packet[7:])
