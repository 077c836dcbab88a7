"""Residue decode, types 0/1/2 (Vorbis I spec §8.6)."""

from __future__ import annotations

from typing import List

import numpy as np

from easyav1.audio.vorbis.bitreader import BitReader, EndOfPacket
from easyav1.audio.vorbis.codebook import VorbisError
from easyav1.audio.vorbis.headers import ResidueConfig


def decode_residue(br: BitReader, cfg: ResidueConfig, codebooks,
                   ch: int, do_not_decode: List[bool], n: int) -> np.ndarray:
    """Decode residue vectors for `ch` channels of length `n`.

    Returns float32 array (ch, n). For type 2 the channels are interleaved
    into a single vector internally and deinterleaved on return.
    """
    if cfg.type == 2:
        out = np.zeros((1, n * ch), dtype=np.float32)
        if not all(do_not_decode):
            _decode_core(br, cfg, codebooks, out, [False], n * ch,
                         interleave=True)
        return out.reshape(n, ch).T.copy()
    out = np.zeros((ch, n), dtype=np.float32)
    _decode_core(br, cfg, codebooks, out, do_not_decode, n, interleave=False)
    return out


def _decode_core(br: BitReader, cfg: ResidueConfig, codebooks,
                 v: np.ndarray, do_not_decode: List[bool], n: int,
                 interleave: bool) -> None:
    actual_size = n
    limit_begin = min(cfg.begin, actual_size)
    limit_end = min(cfg.end, actual_size)
    psize = cfg.partition_size
    n_to_read = limit_end - limit_begin
    if n_to_read <= 0:
        return
    partitions_to_read = n_to_read // psize
    ch = v.shape[0]
    classbook = codebooks[cfg.classbook]
    cdim = classbook.dimensions
    nclass = cfg.classifications
    classifs = np.zeros((ch, partitions_to_read + cdim), dtype=np.int32)

    try:
        for p in range(8):
            partition_count = 0
            while partition_count < partitions_to_read:
                if p == 0:
                    for j in range(ch):
                        if do_not_decode[j]:
                            continue
                        temp = classbook.decode_scalar(br)
                        for i in range(cdim - 1, -1, -1):
                            classifs[j][partition_count + i] = temp % nclass
                            temp //= nclass
                for _ in range(cdim):
                    if partition_count >= partitions_to_read:
                        break
                    for j in range(ch):
                        if do_not_decode[j]:
                            continue
                        vqclass = classifs[j][partition_count]
                        book_idx = cfg.books[vqclass][p]
                        if book_idx < 0:
                            continue
                        book = codebooks[book_idx]
                        offset = limit_begin + partition_count * psize
                        if cfg.type == 0:
                            step = psize // book.dimensions
                            for k in range(step):
                                vec = book.decode_vector(br)
                                v[j, offset + k:offset + k + step * book.dimensions:step] += vec
                        else:  # types 1 and 2 share the format
                            i = 0
                            while i < psize:
                                vec = book.decode_vector(br)
                                v[j, offset + i:offset + i + book.dimensions] += vec
                                i += book.dimensions
                    partition_count += 1
    except EndOfPacket:
        # End-of-packet during residue decode is a normal termination
        # (spec §1.2.1: decode what was read, rest stays zero).
        pass
