"""Vorbis packet decoder: header setup, per-packet symbol decode, and a
host (numpy) synthesis reference path.

Architecture split (per SURVEY.md §7): this module does the
sequential symbol decode (floors, residues) on the host, producing dense
per-packet tensors (`DecodedBlock`); the dense synthesis — coupling,
floor multiply, IMDCT, window overlap-add — runs either here in numpy
(reference/golden path) or batched on the device (audio/vorbis/device.py).

Reference behavior being matched: vorbis_synthesis →
vorbis_synthesis_blockin → vorbis_synthesis_pcmout as called by easyav1
(reference easyav1.c:2434-2499).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from easyav1.audio.vorbis.bitreader import BitReader, EndOfPacket, ilog
from easyav1.audio.vorbis.codebook import VorbisError
from easyav1.audio.vorbis import floor as floor_mod
from easyav1.audio.vorbis.headers import VorbisInfo, FloorConfig0, FloorConfig1
from easyav1.audio.vorbis.residue import decode_residue


@dataclasses.dataclass
class DecodedBlock:
    """Host symbol-decode output for one audio packet — the tensors shipped
    to the device synthesis kernel."""

    n: int                      # blocksize
    long_block: bool            # mode blockflag
    prev_flag: int              # long blocks: previous window shape flag
    next_flag: int              # long blocks: next window shape flag
    residue: np.ndarray         # (channels, n/2) float32, post-coupling-order
    floor: np.ndarray           # (channels, n/2) float32 linear floor curve
    no_residue: np.ndarray      # (channels,) bool - channel had no floor
    coupling: List[Tuple[int, int]]  # (magnitude, angle) steps, forward order


def window_slope(width: int) -> np.ndarray:
    """The Vorbis window slope: sin(pi/2 * sin^2(pi/2 * (j+0.5)/W))."""
    j = np.arange(width, dtype=np.float64) + 0.5
    return np.sin(0.5 * np.pi * np.sin(0.5 * np.pi * j / width) ** 2)


def build_window(n: int, n0: int, n1: int, long_block: bool,
                 prev_flag: int, next_flag: int) -> np.ndarray:
    """Full n-length window honoring neighbor block flags (spec §4.3.1)."""
    w = np.zeros(n, dtype=np.float64)
    left_w = n1 // 2 if (long_block and prev_flag) else n0 // 2
    right_w = n1 // 2 if (long_block and next_flag) else n0 // 2
    if not long_block:
        left_w = right_w = n // 2
    left_start = n // 4 - left_w // 2
    right_center = 3 * n // 4
    right_start = right_center - right_w // 2
    slope_l = window_slope(left_w)
    slope_r = window_slope(right_w)[::-1]
    w[left_start:left_start + left_w] = slope_l
    w[left_start + left_w:right_start] = 1.0
    w[right_start:right_start + right_w] = slope_r
    return w


def imdct_matrix(n: int) -> np.ndarray:
    """IMDCT as a dense (n/2, n) matrix — on the device this becomes a
    matmul (spec §4.3.6: y[j] = sum_k X[k] cos(2pi/n (j+.5+n/4)(k+.5)))."""
    n2 = n // 2
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n2, dtype=np.float64)
    return np.cos(2 * np.pi / n * np.outer(k + 0.5, j + 0.5 + n / 4))


_IMDCT_TW: dict = {}


def imdct_fft(spec: np.ndarray, n: int) -> np.ndarray:
    """O(n log n) IMDCT of (ch, n/2) spectra -> (ch, n) samples; same
    definition as imdct_matrix:
        y[j] = sum_k X[k] cos(2pi/n (j+.5+n/4)(k+.5))
             = Re[e^{i pi (j+.5+n/4)/n} * n*ifft(X[k] e^{i pi k (1/n + 1/2)})]
    Computed in complex64 (libvorbis itself synthesizes in float32, so
    the tolerance-checked PCM contract is unchanged); the zero-padded
    upper half means the ifft input is length n but only n/2 lanes are
    nonzero.  (Host hot path; the device path keeps the dense matmul.)"""
    tw = _IMDCT_TW.get(n)
    if tw is None:
        k = np.arange(n // 2, dtype=np.float64)
        pre = np.exp(1j * np.pi * k * (1.0 / n + 0.5))
        j = np.arange(n, dtype=np.float64)
        post = np.exp(1j * np.pi * (j + 0.5 + n / 4.0) / n)
        tw = (pre.astype(np.complex64), post.astype(np.complex64))
        _IMDCT_TW[n] = tw
    pre, post = tw
    a = np.zeros(spec.shape[:-1] + (n,), np.complex64)
    a[..., :n // 2] = spec.astype(np.float32) * pre
    f = np.fft.ifft(a, axis=-1)
    f *= np.float32(n)
    return (post * f).real


class VorbisDecoder:
    """Stateful Vorbis decoder for one stream."""

    def __init__(self, headers: List[bytes]):
        if len(headers) != 3:
            raise VorbisError("expected 3 header packets")
        self.info = VorbisInfo()
        self.info.parse_ident(headers[0])
        # headers[1] is the comment header - ignored.
        self.info.parse_setup(headers[2])
        self._mode_bits = ilog(len(self.info.modes) - 1)
        self._imdct = {}
        self._windows = {}
        # native (C) symbol-decode fast path; Python remains the
        # verified reference (EASYAV1_NATIVE=0 forces it)
        self._native = None
        import os
        if os.environ.get("EASYAV1_NATIVE", "1") != "0":
            try:
                from easyav1.audio.vorbis.native import NativeVorbis
                self._native = NativeVorbis(self.info)
            except Exception:
                self._native = None
        self.reset()

    # -- setup introspection ----------------------------------------------

    def spectral_band_limits(self) -> Tuple[int, int]:
        """(long_bins, short_bins): the highest spectral bin any packet
        of this stream can populate, per block size.  Residue decode
        covers [begin, end) fixed by the setup header, so every bin >=
        max(end) is identically zero — the device synth uploads only
        the live band (see VorbisDeviceSynth band_limit)."""
        info = self.info
        lim = [0, 0]  # indexed by blockflag
        for mode in info.modes:
            mapping = info.mappings[mode.mapping]
            half = (info.blocksize1 if mode.blockflag
                    else info.blocksize0) // 2
            end = 0
            for s in range(mapping.submaps):
                rcfg = info.residues[mapping.submap_residue[s]]
                e = rcfg.end
                if rcfg.type == 2:
                    # type-2 interleaves channels: spectral reach is
                    # end / channels, rounded up
                    e = -(-e // info.channels)
                end = max(end, min(e, half))
            lim[mode.blockflag] = max(lim[mode.blockflag], end)
        return (lim[1] or info.blocksize1 // 2,
                lim[0] or info.blocksize0 // 2)

    # -- state -------------------------------------------------------------

    def reset(self) -> None:
        """Parity: vorbis_synthesis_restart (used on seek, easyav1.c:3077)."""
        self._cache: Optional[np.ndarray] = None  # (ch, n1/2) tail signal
        self._prev_n: int = 0
        if self._native is not None:
            self._native.synth_reset()

    # -- symbol decode (host) ----------------------------------------------

    def decode_packet_symbols(self, packet: bytes) -> Optional[DecodedBlock]:
        """Entropy-decode one audio packet into dense tensors.
        Returns None for non-audio packets (parity: vorbis_synthesis
        returning OV_ENOTAUDIO)."""
        if self._native is not None:
            return self._native.decode_packet(packet)
        info = self.info
        br = BitReader(packet)
        # Mode header: a truncation here means no block at all.
        try:
            if br.read1() != 0:
                return None  # header packet in audio stream
            mode_idx = br.read(self._mode_bits)
            if mode_idx >= len(info.modes):
                raise VorbisError("mode out of range")
            mode = info.modes[mode_idx]
            mapping = info.mappings[mode.mapping]
            long_block = bool(mode.blockflag)
            n = info.blocksize1 if long_block else info.blocksize0
            prev_flag = next_flag = 0
            if long_block:
                prev_flag = br.read1()
                next_flag = br.read1()
        except EndOfPacket:
            return None

        n2 = n // 2
        ch = info.channels
        floor_data: List[Optional[object]] = [None] * ch
        no_residue = np.ones(ch, dtype=bool)
        residue = np.zeros((ch, n2), dtype=np.float32)
        try:
            # 1. floor decode per channel
            for c in range(ch):
                fidx = mapping.submap_floor[mapping.mux[c]]
                ftype = info.floor_types[fidx]
                fcfg = info.floor_configs[fidx]
                if ftype == 1:
                    fd = floor_mod.decode_floor1(br, fcfg, info.codebooks)
                else:
                    fd = floor_mod.decode_floor0(br, fcfg, info.codebooks)
                floor_data[c] = fd
                no_residue[c] = fd is None
            # 2. nonzero vector propagation through coupling
            do_not_decode_base = no_residue.copy()
            for m, a in zip(mapping.magnitude, mapping.angle):
                if not (no_residue[m] and no_residue[a]):
                    do_not_decode_base[m] = False
                    do_not_decode_base[a] = False
            # 3. residue decode per submap
            for s in range(mapping.submaps):
                chans = [c for c in range(ch) if mapping.mux[c] == s]
                dnd = [bool(do_not_decode_base[c]) for c in chans]
                rcfg = info.residues[mapping.submap_residue[s]]
                dec = decode_residue(br, rcfg, info.codebooks,
                                     len(chans), dnd, n2)
                for i, c in enumerate(chans):
                    residue[c] = dec[i]
        except EndOfPacket:
            # Truncated packet: decoded parts are kept, the rest stays
            # zero/unused (spec §1.2.1 "end of packet" semantics).
            pass

        # 4. floor curve synthesis (host: integer render into dB table)
        floor_curves = np.zeros((ch, n2), dtype=np.float32)
        for c in range(ch):
            fidx = mapping.submap_floor[mapping.mux[c]]
            ftype = info.floor_types[fidx]
            fcfg = info.floor_configs[fidx]
            fd = floor_data[c]
            if fd is None:
                continue
            if ftype == 1:
                floor_curves[c] = floor_mod.synthesize_floor1(fd, fcfg, n2)
            else:
                amp, coeffs = fd
                floor_curves[c] = floor_mod.synthesize_floor0(amp, coeffs, fcfg, n2)

        return DecodedBlock(
            n=n, long_block=long_block, prev_flag=prev_flag, next_flag=next_flag,
            residue=residue, floor=floor_curves, no_residue=no_residue,
            coupling=list(zip(mapping.magnitude, mapping.angle)),
        )

    # -- host synthesis reference path --------------------------------------

    @staticmethod
    def inverse_coupling(residue: np.ndarray, coupling) -> np.ndarray:
        """Magnitude/angle square-polar decoupling (spec §4.3.5), applied
        in reverse step order."""
        res = residue.copy()
        for m, a in reversed(coupling):
            M = res[m].copy()
            A = res[a].copy()
            newM = np.where(M > 0,
                            np.where(A > 0, M, M + A),
                            np.where(A > 0, M, M - A))
            newA = np.where(M > 0,
                            np.where(A > 0, M - A, M),
                            np.where(A > 0, M + A, M))
            res[m] = newM
            res[a] = newA
        return res

    def _get_imdct(self, n: int) -> np.ndarray:
        if n not in self._imdct:
            self._imdct[n] = imdct_matrix(n)
        return self._imdct[n]

    def _get_window(self, key) -> np.ndarray:
        if key not in self._windows:
            n, long_block, pf, nf = key
            self._windows[key] = build_window(
                n, self.info.blocksize0, self.info.blocksize1,
                long_block, pf, nf)
        return self._windows[key]

    def synthesize_block_host(self, blk: DecodedBlock) -> np.ndarray:
        """Full host synthesis of one block; returns (samples, ch) float32
        PCM ready for output (0 samples for the first block)."""
        if self._native is not None:
            return self._native.synth_block(blk)
        info = self.info
        n = blk.n
        n2 = n // 2
        ch = info.channels
        res = self.inverse_coupling(blk.residue, blk.coupling)
        spec = res * blk.floor  # (ch, n2); floor==0 for unused channels
        # IMDCT: O(n log n) FFT form (bit-matches the matrix within
        # float tolerance; the device path keeps the dense matmul)
        pcm = imdct_fft(spec.astype(np.float64), n)
        w = self._get_window((n, blk.long_block, blk.prev_flag, blk.next_flag))
        pcm *= w

        if self._cache is None:
            self._cache = np.zeros((ch, info.blocksize1 // 2))
            self._cache[:, :n2] = pcm[:, n2:]
            self._prev_n = n
            return np.zeros((0, ch), dtype=np.float32)

        n_prev = self._prev_n
        L = n_prev // 4 + n // 4
        out = np.zeros((ch, L))
        avail = min(L, n_prev // 2)
        out[:, :avail] = self._cache[:, :avail]
        l0 = (n - n_prev) // 4
        if l0 >= 0:
            out += pcm[:, l0:l0 + L]
        else:
            out[:, -l0:] += pcm[:, :n2]
        self._cache[:] = 0
        self._cache[:, :n2] = pcm[:, n2:]
        self._prev_n = n
        return out.T.astype(np.float32)

    def track_block(self, blk: DecodedBlock) -> int:
        """Decode-free position tracking (parity:
        vorbis_synthesis_trackonly + blockin, minivorbis.h:12854):
        advances the overlap-add bookkeeping without coupling/IMDCT and
        returns the sample count the block would have produced.  The
        lap cache is zeroed, so the first synthesized block after a
        seek overlaps with silence — matching a restarted decoder."""
        if self._native is not None:
            return self._native.synth_track(blk.n)
        n = blk.n
        if self._cache is None:
            self._cache = np.zeros(
                (self.info.channels, self.info.blocksize1 // 2))
            self._prev_n = n
            return 0
        out = self._prev_n // 4 + n // 4
        self._cache[:] = 0
        self._prev_n = n
        return out

    def decode_packet_host(self, packet: bytes) -> np.ndarray:
        """Convenience: symbols + host synthesis. (samples, ch) float32.
        With the native library this is a single fused C call per packet
        (no intermediate block tensors cross the FFI)."""
        if self._native is not None:
            pcm = self._native.decode_pcm(packet)
            if pcm is None:
                return np.zeros((0, self.info.channels), dtype=np.float32)
            return pcm
        blk = self.decode_packet_symbols(packet)
        if blk is None:
            return np.zeros((0, self.info.channels), dtype=np.float32)
        return self.synthesize_block_host(blk)
