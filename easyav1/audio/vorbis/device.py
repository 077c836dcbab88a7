"""Device Vorbis synthesis: batched coupling + floor multiply + IMDCT +
window overlap-add as one jitted chunk computation.

Replaces minivorbis's scalar mdct_backward + blockin (reference
minivorbis.h:7054,9195): the IMDCT is expressed as a dense (n/2, n)
cosine matrix so a whole chunk of blocks becomes a single matmul, run
at Precision.HIGHEST (full f32 products, never TF32), and the window
overlap-add becomes one scatter-add into an output buffer.  Host code assembles fixed-shape chunks (padding with
silent blocks) so every call hits the same compiled executable.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from easyav1.audio.vorbis.decoder import (
    DecodedBlock, build_window, imdct_matrix,
)


class VorbisDeviceSynth:
    """Device synthesis engine for one stream configuration.

    Chunk layout: B blocks. Short-block spectra ride in a separate, smaller
    batch input; both IMDCTs run on the full batch (the short matmul is
    negligible; the long one dominates and stays one dense matmul).
    """

    # window_id values
    W_SHORT, W_L00, W_L01, W_L10, W_L11, W_ZERO = range(6)

    def __init__(self, channels: int, n0: int, n1: int,
                 coupling: Tuple[Tuple[int, int], ...],
                 chunk: int = 64,
                 band_limit: Tuple[int, int] = (0, 0)):
        """band_limit = (long_bins, short_bins): the stream's static
        residue-decode ceiling (max residue ``end`` reachable from
        long/short modes, see VorbisDecoder.spectral_band_limits).
        Spectral bins above it are identically zero for every packet,
        so the host->device upload carries only the live band.  0
        means "no limit known" (full n/2)."""
        self.ch = channels
        self.n0 = n0
        self.n1 = n1
        self.chunk = chunk
        self.coupling = tuple(coupling)

        def _bl(limit, half):
            if not limit or limit >= half:
                return half
            return min(half, max(128, -(-limit // 128) * 128))

        self.bl1 = _bl(band_limit[0], n1 // 2)  # live long-block bins
        self.bl0 = _bl(band_limit[1], n0 // 2)  # live short-block bins
        self._state_cache = np.zeros((channels, n1 // 2), np.float32)
        self._prev_n = 0  # 0 = no previous block yet
        # Window table padded to n1; id 5 = zeros (padding blocks).
        wins = np.zeros((6, n1), np.float64)
        wins[0, :n0] = build_window(n0, n0, n1, False, 0, 0)
        wins[1] = build_window(n1, n0, n1, True, 0, 0)
        wins[2] = build_window(n1, n0, n1, True, 0, 1)
        wins[3] = build_window(n1, n0, n1, True, 1, 0)
        wins[4] = build_window(n1, n0, n1, True, 1, 1)
        self._windows = jnp.asarray(wins, jnp.float32)
        self._imdct0 = jnp.asarray(imdct_matrix(n0), jnp.float32)
        self._imdct1 = jnp.asarray(imdct_matrix(n1), jnp.float32)
        self._pad = n1  # headroom for negative block offsets
        self._buf_len = self._pad + chunk * (n1 // 2) + n1
        self._fn = jax.jit(self._make_fn())
        self._cache_dev = None     # device-resident carried tail
        self._pend: list = []      # (device buf, emit) awaiting fetch
        self._hold: List[DecodedBlock] = []   # sub-chunk backlog

    def reset(self) -> None:
        self._state_cache = np.zeros((self.ch, self.n1 // 2), np.float32)
        self._prev_n = 0
        self._cache_dev = None
        self._pend = []
        self._hold = []

    # ------------------------------------------------------------------

    def _make_fn(self):
        ch, n0, n1 = self.ch, self.n0, self.n1
        B = self.chunk
        P = self._pad
        BUF = self._buf_len
        bl0, bl1 = self.bl0, self.bl1
        windows = self._windows
        imdct0, imdct1 = self._imdct0, self._imdct1
        hp = jax.lax.Precision.HIGHEST

        def synth(spec, meta, cache):
            """spec: (B*ch*(n1//2 + n0//2),) flat f32 = the long-block
            spectra followed by the short-block spectra, already
            channel-decoupled and floor-multiplied on the host (exact
            f32 elementwise work the host does while the previous
            chunk is still in flight — and it halves the host->device
            bytes vs shipping residue+floor separately);
            meta: (2*B+1,) int32 = [window_ids | offsets | emit];
            cache: (ch, n1//2) carried tail.  One upload per chunk,
            not one per argument.
            Returns (buf, next_cache); the cache slice is computed on
            device so chained chunks never round-trip to the host."""
            nl = B * ch * bl1
            spec_l = spec[:nl].reshape(B, ch, bl1)
            spec_s = spec[nl:].reshape(B, ch, bl0)
            window_ids = meta[:B]
            offsets = meta[B:2 * B]
            emit = meta[2 * B]
            # IMDCT: (B*ch, bl) @ (bl, n).  Rows of the
            # IMDCT matrix above the band limit multiply bins that are
            # identically zero, so slicing them off is exact.
            pcm_l = jnp.matmul(spec_l.reshape(B * ch, bl1), imdct1[:bl1],
                               precision=hp).reshape(B, ch, n1)
            pcm_s = jnp.matmul(spec_s.reshape(B * ch, bl0), imdct0[:bl0],
                               precision=hp).reshape(B, ch, n0)
            pcm = pcm_l.at[:, :, :n0].add(pcm_s)
            # Window: gather per-block window and multiply.
            win = windows[window_ids]  # (B, n1)
            pcm = pcm * win[:, None, :]

            buf = jnp.zeros((ch, BUF), jnp.float32)
            buf = jax.lax.dynamic_update_slice(buf, cache, (0, P))

            # Overlap-add as ONE scatter-add: every output sample gets
            # contributions from at most two windows (vorbis OLA
            # invariant), and two-operand float addition is commutative,
            # so the unordered XLA scatter is bit-identical to the
            # sequential loop it replaces (which cost B serial device
            # ops per chunk).
            idx = offsets[:, None] + jnp.arange(n1)[None, :]   # (B, n1)
            buf = buf.at[:, idx].add(
                jnp.transpose(pcm, (1, 0, 2)),
                mode="promise_in_bounds")
            next_cache = jax.lax.dynamic_slice(
                buf, (0, P + emit), (ch, n1 // 2))
            return buf, next_cache

        return synth

    # ------------------------------------------------------------------

    def process(self, blocks: List[DecodedBlock]) -> np.ndarray:
        """Synthesize a list of blocks (any count; internally chunked).
        Returns (samples, ch) float32 PCM."""
        self.begin()
        self.feed(blocks)
        return self.finish()

    # -- streaming interface -------------------------------------------
    #
    # begin() / feed() / finish() let the caller interleave host symbol
    # decode with device synthesis: feed() dispatches full chunks
    # asynchronously (device->host copies start immediately and overlap
    # both later chunks and the caller's own work); finish() pads and
    # dispatches the remainder and fetches every pending buffer once.

    def begin(self) -> None:
        self._pend = []
        self._hold: List[DecodedBlock] = []

    def feed(self, blocks: List[DecodedBlock]) -> None:
        self._hold.extend(blocks)
        while len(self._hold) >= self.chunk:
            self._dispatch_async(self._hold[:self.chunk])
            self._hold = self._hold[self.chunk:]

    def finish(self) -> np.ndarray:
        if self._hold:
            self._dispatch_async(self._hold)
            self._hold = []
        pend, self._pend = self._pend, []
        if not pend:
            return np.zeros((0, self.ch), np.float32)
        P = self._pad
        bufs = jax.device_get([b for b, _ in pend])
        out = [np.asarray(buf)[:, P:P + emit].T
               for buf, (_, emit) in zip(bufs, pend)]
        return np.concatenate(out, axis=0)

    def _dispatch_async(self, blocks: List[DecodedBlock]) -> None:
        buf, emit = self._dispatch_chunk(blocks)
        try:
            buf.copy_to_host_async()   # overlap D2H with later work
        except AttributeError:
            pass
        self._pend.append((buf, emit))

    def _process_chunk(self, blocks: List[DecodedBlock]) -> np.ndarray:
        buf, emit = self._dispatch_chunk(blocks)
        P = self._pad
        return np.asarray(buf)[:, P:P + emit].T.copy()

    def _dispatch_chunk(self, blocks: List[DecodedBlock]):
        B, ch, n0, n1 = self.chunk, self.ch, self.n0, self.n1
        P = self._pad
        bl0, bl1 = self.bl0, self.bl1
        nl = B * ch * bl1
        spec = np.zeros(nl + B * ch * bl0, np.float32)
        spec_l = spec[:nl].reshape(B, ch, bl1)
        spec_s = spec[nl:].reshape(B, ch, bl0)
        res_l = np.zeros((B, ch, bl1), np.float32)
        flo_l = np.zeros((B, ch, bl1), np.float32)
        res_s = np.zeros((B, ch, bl0), np.float32)
        flo_s = np.zeros((B, ch, bl0), np.float32)
        meta = np.zeros(2 * B + 1, np.int32)
        wids = meta[:B]
        wids[:] = self.W_ZERO
        offsets = meta[B:2 * B]

        prev_n = self._prev_n
        emit = 0  # emission pointer, buffer coords relative to P
        lengths = []
        for k, blk in enumerate(blocks):
            n = blk.n
            assert tuple(blk.coupling) == self.coupling, \
                "per-chunk coupling mismatch (multiple mappings)"
            if blk.long_block:
                wids[k] = 1 + (blk.prev_flag << 1) + blk.next_flag
                res_l[k] = blk.residue[:, :bl1]
                flo_l[k] = blk.floor[:, :bl1]
            else:
                wids[k] = self.W_SHORT
                res_s[k] = blk.residue[:, :bl0]
                flo_s[k] = blk.floor[:, :bl0]
            # The block's window center lands on the post-emission pointer
            # (emit + L); its buffer start is therefore center - n/2.
            L = 0 if prev_n == 0 else prev_n // 4 + n // 4
            a = emit + L - n // 2
            offsets[k] = P + a
            emit += L
            lengths.append(L)
            prev_n = n

        # Channel decoupling + floor multiply, vectorized on the host.
        # Exact same f32 elementwise ops the device kernel used to do,
        # so the result is bit-identical — but the upload shrinks 2x.
        for res, flo in ((res_l, flo_l), (res_s, flo_s)):
            for m, a in reversed(self.coupling):
                M, A = res[:, m], res[:, a]
                pm, pa = M > 0, A > 0
                newM = np.where(pm, np.where(pa, M, M + A),
                                np.where(pa, M, M - A))
                newA = np.where(pm, np.where(pa, M - A, M),
                                np.where(pa, M + A, M))
                res[:, m] = newM
                res[:, a] = newA
        np.multiply(res_l, flo_l, out=spec_l)
        np.multiply(res_s, flo_s, out=spec_s)

        if self._cache_dev is None:
            self._cache_dev = jnp.asarray(self._state_cache)
        meta[2 * B] = emit
        buf, self._cache_dev = self._fn(
            jnp.asarray(spec), jnp.asarray(meta), self._cache_dev,
        )
        self._prev_n = prev_n
        return buf, emit
