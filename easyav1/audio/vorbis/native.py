"""ctypes bridge to the native Vorbis packet symbol decoder.

The Python headers module parses and validates the three header packets
once per stream; this module marshals the resulting static state
(codebook codewords + precomputed VQ vectors, floor/residue/mapping/mode
configs) into a flat binary blob consumed by native/vorbis_dec.c, and
wraps the per-packet decode into the same `DecodedBlock` the Python
reference produces.  Reference parity: the packet->spectrum half of
minivorbis' vorbis_synthesis (ext/minivorbis/minivorbis.h:12786).
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional

import numpy as np

from easyav1.audio.vorbis.bitreader import ilog
from easyav1.audio.vorbis.codebook import assign_codewords
from easyav1.audio.vorbis.headers import VorbisInfo
from easyav1.audio.vorbis.tables import FLOOR1_INVERSE_DB_TABLE


def _i32(*vals) -> bytes:
    return struct.pack(f"<{len(vals)}i", *vals)


def pack_setup(info: VorbisInfo) -> Optional[bytes]:
    """Marshal parsed stream state into the vorbis_dec.c blob format.
    Returns None when the stream is outside the native decoder's bounds
    (channels > 8) — caller falls back to the Python path."""
    if info.channels > 8:
        return None
    out = [
        _i32(info.channels, info.blocksize0, info.blocksize1,
             ilog(len(info.modes) - 1), len(info.codebooks))
    ]
    for cb in info.codebooks:
        single_entry = cb._single_entry if cb._single_entry is not None \
            else -1
        single_len = cb._single_len if single_entry >= 0 else 0
        codes: List[tuple] = []
        if single_entry < 0 and cb.used_entries > 0:
            assigned = assign_codewords(cb.lengths)
            for entry, (code, ln) in enumerate(zip(assigned, cb.lengths)):
                if code is not None:
                    codes.append((entry, ln, code))
        out.append(_i32(cb.dimensions, cb.entries, single_entry,
                        single_len, len(codes)))
        for (entry, ln, code) in codes:
            out.append(struct.pack("<iiI", entry, ln, code))
        if cb.vectors is not None:
            out.append(_i32(1))
            out.append(np.ascontiguousarray(
                cb.vectors, dtype=np.float32).tobytes())
        else:
            out.append(_i32(0))
    out.append(_i32(len(info.floor_types)))
    for ftype, fcfg in zip(info.floor_types, info.floor_configs):
        out.append(_i32(ftype))
        if ftype == 1:
            n_classes = len(fcfg.class_dimensions)
            out.append(_i32(n_classes, len(fcfg.partition_class_list)))
            out.append(_i32(*fcfg.partition_class_list)
                       if fcfg.partition_class_list else b"")
            out.append(_i32(*fcfg.class_dimensions))
            out.append(_i32(*fcfg.class_subclasses))
            out.append(_i32(*[b if b is not None else -1
                              for b in fcfg.class_masterbooks]))
            sub = []
            for cls in range(n_classes):
                row = list(fcfg.subclass_books[cls])[:8]
                row += [-1] * (8 - len(row))
                sub.extend(row)
            out.append(_i32(*sub))
            out.append(_i32(fcfg.multiplier, len(fcfg.x_list)))
            out.append(_i32(*fcfg.x_list))
            out.append(_i32(*fcfg.sorted_index))
            out.append(_i32(*[n[0] for n in fcfg.neighbors]))
            out.append(_i32(*[n[1] for n in fcfg.neighbors]))
            out.append(_i32(fcfg.range))
        else:
            out.append(_i32(fcfg.order, fcfg.rate, fcfg.bark_map_size,
                            fcfg.amplitude_bits, fcfg.amplitude_offset,
                            len(fcfg.book_list)))
            out.append(_i32(*fcfg.book_list))
    out.append(_i32(len(info.residues)))
    for r in info.residues:
        out.append(_i32(r.type, r.begin, r.end, r.partition_size,
                        r.classifications, r.classbook))
        books = []
        for cls in range(r.classifications):
            row = list(r.books[cls])[:8]
            row += [-1] * (8 - len(row))
            books.extend(row)
        out.append(_i32(*books))
    out.append(_i32(len(info.mappings)))
    for m in info.mappings:
        out.append(_i32(m.submaps, m.coupling_steps))
        out.append(_i32(*m.magnitude) if m.magnitude else b"")
        out.append(_i32(*m.angle) if m.angle else b"")
        out.append(_i32(*m.mux))
        out.append(_i32(*m.submap_floor))
        out.append(_i32(*m.submap_residue))
    out.append(_i32(len(info.modes)))
    for md in info.modes:
        out.append(_i32(md.blockflag, md.mapping))
    out.append(np.asarray(FLOOR1_INVERSE_DB_TABLE,
                          dtype=np.float32).tobytes())
    return b"".join(out)


class NativeVorbis:
    """Per-stream handle over the C symbol decoder.  decode_packet
    returns the same DecodedBlock the Python reference produces (or
    None for non-audio packets)."""

    def __init__(self, info: VorbisInfo):
        from easyav1 import native as native_mod
        self._lib = native_mod._load()
        self._handle = None
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        blob = pack_setup(info)
        if blob is None:
            raise RuntimeError("stream outside native decoder bounds")
        self._blob = blob           # keep alive
        self._handle = self._lib.vorbis_create(blob, len(blob))
        if not self._handle:
            raise RuntimeError("vorbis_create failed")
        self.info = info
        ch = info.channels
        n2max = info.blocksize1 // 2
        self._res = np.zeros((ch, n2max), dtype=np.float32)
        self._floor = np.zeros((ch, n2max), dtype=np.float32)
        self._nores = np.zeros(ch, dtype=np.uint8)
        self._flags = np.zeros(4, dtype=np.int32)

    def decode_packet(self, packet: bytes):
        from easyav1.audio.vorbis.decoder import DecodedBlock
        r = self._lib.vorbis_decode_packet(
            self._handle, packet, len(packet),
            self._res.ctypes.data_as(ctypes.c_void_p),
            self._floor.ctypes.data_as(ctypes.c_void_p),
            self._nores.ctypes.data_as(ctypes.c_void_p),
            self._flags.ctypes.data_as(ctypes.c_void_p))
        if r == 0:
            return None
        n = int(self._flags[0])
        n2 = n // 2
        mode_long = bool(self._flags[1])
        # mapping for the decoded mode: coupling steps come from the
        # mode's mapping; recover it the same way the C side did
        # (first bits of the packet) — cheaper: modes/mappings are tiny
        from easyav1.audio.vorbis.bitreader import BitReader
        br = BitReader(packet)
        br.read1()
        mode_idx = br.read(ilog(len(self.info.modes) - 1))
        mapping = self.info.mappings[self.info.modes[mode_idx].mapping]
        return DecodedBlock(
            n=n, long_block=mode_long,
            prev_flag=int(self._flags[2]), next_flag=int(self._flags[3]),
            residue=self._res[:, :n2].copy(),
            floor=self._floor[:, :n2].copy(),
            no_residue=self._nores.astype(bool).copy(),
            coupling=list(zip(mapping.magnitude, mapping.angle)),
        )

    def synth_block(self, blk) -> np.ndarray:
        """Full C host synthesis of one DecodedBlock: coupling, floor
        multiply, FFT IMDCT, window, overlap-add.  Returns (samples,
        ch) float32 PCM (0 samples for the first block).  Parity:
        decoder.synthesize_block_host (the Python reference)."""
        ch = self.info.channels
        res = np.ascontiguousarray(blk.residue, np.float32)
        flo = np.ascontiguousarray(blk.floor, np.float32)
        flags = np.array([blk.n, int(blk.long_block), blk.prev_flag,
                          blk.next_flag], np.int32)
        coup = np.asarray([v for mn in blk.coupling for v in mn],
                          np.int32)
        out = np.empty((self.info.blocksize1 // 2, ch), np.float32)
        n = self._lib.vorbis_synth_block(
            self._handle,
            res.ctypes.data_as(ctypes.c_void_p),
            flo.ctypes.data_as(ctypes.c_void_p),
            res.shape[1],
            flags.ctypes.data_as(ctypes.c_void_p),
            coup.ctypes.data_as(ctypes.c_void_p) if coup.size
            else None,
            len(blk.coupling),
            out.ctypes.data_as(ctypes.c_void_p))
        return out[:n].copy()

    def synth_track(self, n: int) -> int:
        return int(self._lib.vorbis_synth_track(self._handle, n))

    def decode_pcm(self, packet: bytes):
        """Fused symbol decode + synthesis: one FFI call per packet.
        Returns (samples, ch) float32 PCM, or None for non-audio
        packets."""
        ch = self.info.channels
        out = np.empty((self.info.blocksize1 // 2, ch), np.float32)
        n = self._lib.vorbis_decode_pcm(
            self._handle, packet, len(packet),
            out.ctypes.data_as(ctypes.c_void_p))
        if n < 0:
            return None
        return out[:n]

    def synth_reset(self) -> None:
        self._lib.vorbis_synth_reset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.vorbis_destroy(self._handle)
            self._handle = None
