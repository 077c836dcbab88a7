"""Floor 1 packet decode and curve synthesis (Vorbis I spec §7.2.3-7.2.4),
plus floor 0 (LSP) decode (§6).

Curve synthesis returns the *linear* floor curve exactly as libvorbis
computes it (integer render_line into the 256-entry inverse-dB table), so
the downstream floor multiply is bit-identical in float32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from easyav1.audio.vorbis.bitreader import BitReader, EndOfPacket, ilog
from easyav1.audio.vorbis.codebook import VorbisError
from easyav1.audio.vorbis.headers import FloorConfig0, FloorConfig1
from easyav1.audio.vorbis.tables import FLOOR1_INVERSE_DB_TABLE


def render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    """Integer line point (spec §9.2.6)."""
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def decode_floor1(br: BitReader, cfg: FloorConfig1, codebooks) -> Optional[List[int]]:
    """Returns the final_Y post values, or None if the channel is unused."""
    if not br.read1():
        return None
    rng = cfg.range
    ybits = ilog(rng - 1)
    y = [br.read(ybits), br.read(ybits)]
    offset = 2
    for cls in cfg.partition_class_list:
        cdim = cfg.class_dimensions[cls]
        cbits = cfg.class_subclasses[cls]
        csub = (1 << cbits) - 1
        cval = 0
        if cbits:
            cval = codebooks[cfg.class_masterbooks[cls]].decode_scalar(br)
        for _ in range(cdim):
            book = cfg.subclass_books[cls][cval & csub]
            cval >>= cbits
            if book >= 0:
                y.append(codebooks[book].decode_scalar(br))
            else:
                y.append(0)
        offset += cdim
    # Amplitude value synthesis (spec §7.2.4 step 1).
    final_y = [y[0], y[1]]
    step2 = [True, True]
    for i in range(2, len(cfg.x_list)):
        low, high = cfg.neighbors[i]
        predicted = render_point(cfg.x_list[low], final_y[low],
                                 cfg.x_list[high], final_y[high],
                                 cfg.x_list[i])
        val = y[i]
        highroom = rng - predicted
        lowroom = predicted
        room = 2 * min(highroom, lowroom)
        if val:
            step2[low] = True
            step2[high] = True
            step2.append(True)
            if val >= room:
                if highroom > lowroom:
                    final_y.append(val - lowroom + predicted)
                else:
                    final_y.append(predicted - val + highroom - 1)
            else:
                if val & 1:
                    final_y.append(predicted - ((val + 1) >> 1))
                else:
                    final_y.append(predicted + (val >> 1))
        else:
            step2.append(False)
            final_y.append(predicted)
    # Encode step2 flag into the value sign-bit convention used by
    # synthesize_floor1: clamp + mark.
    return [fy if s else -fy - 1 for fy, s in zip(final_y, step2)]
    # (negative encoding: -v-1 means "not step2", value v)


def synthesize_floor1(posts: List[int], cfg: FloorConfig1, n2: int) -> np.ndarray:
    """Curve synthesis (spec §7.2.4 step 2) -> linear float32 curve of
    length n2 (= blocksize/2)."""
    rng = cfg.range
    xs = cfg.x_list
    mult = cfg.multiplier
    # Decode step2 flag from the sign encoding.
    pts: List[Tuple[int, int]] = []
    for idx in cfg.sorted_index:
        v = posts[idx]
        if v >= 0:
            yv = min(max(v, 0), rng - 1)
            pts.append((xs[idx], yv))
    out = np.zeros(n2, dtype=np.int32)
    if not pts:
        return np.zeros(n2, dtype=np.float32)
    lx, ly = pts[0]
    ly *= mult
    if lx > 0:
        out[:min(lx, n2)] = ly
    for hx, hy in pts[1:]:
        hy *= mult
        if lx < n2:
            _render_line(lx, ly, hx, hy, out, n2)
        lx, ly = hx, hy
    if lx < n2:
        out[lx:] = ly
    np.clip(out, 0, 255, out=out)
    return FLOOR1_INVERSE_DB_TABLE[out]


def _render_line(x0: int, y0: int, x1: int, y1: int, v: np.ndarray, n: int) -> None:
    """Integer Bresenham as specified (spec §9.2.7), vectorized.

    The spec's loop yields y[x] = y0 + floor((x - x0) * dy / adx) for
    dy >= 0 and y0 - floor((x - x0) * ady / adx) for dy < 0 (base is
    truncated division; err accumulation adds the remainder steps).
    """
    dy = y1 - y0
    adx = x1 - x0
    if adx <= 0:
        return
    end = min(x1, n)
    if end <= x0:
        return
    xs = np.arange(0, end - x0, dtype=np.int64)
    ady = abs(dy)
    off = (xs * ady) // adx
    ys = y0 + off if dy >= 0 else y0 - off
    v[x0:end] = ys


# ---------------------------------------------------------------------------
# Floor 0 (LSP) — rare in practice; libvorbis encoder emits floor 1 only.

def decode_floor0(br: BitReader, cfg: FloorConfig0, codebooks) -> Optional[Tuple[float, List[float]]]:
    """Returns (amplitude, coefficients) or None for unused channel."""
    amplitude = br.read(cfg.amplitude_bits)
    if amplitude <= 0:
        return None
    booknumber = br.read(ilog(len(cfg.book_list) - 1))
    if booknumber >= len(cfg.book_list):
        raise VorbisError("floor0 book number out of range")
    book = codebooks[cfg.book_list[booknumber]]
    coefficients: List[float] = []
    last = 0.0
    while len(coefficients) < cfg.order:
        vec = book.decode_vector(br)
        coefficients.extend(float(t) + last for t in vec)
        last = coefficients[-1]
    return float(amplitude), coefficients[:cfg.order]


def synthesize_floor0(amplitude: float, coeffs: List[float], cfg: FloorConfig0,
                      n2: int) -> np.ndarray:
    """Floor0 curve computation (spec §6.2.3): LSP to linear curve."""
    omega_map = _bark_map(cfg, n2)
    order = cfg.order
    lsp = np.array(coeffs[:order], dtype=np.float64)
    cos_lsp = np.cos(lsp)
    w = np.cos(omega_map)  # (n2,)
    # p/q products per spec
    if order % 2:
        p = (1 - w ** 2) * np.prod(
            4 * (w[:, None] - cos_lsp[None, 1::2]) ** 2, axis=1)
        q = 0.25 * np.prod(4 * (w[:, None] - cos_lsp[None, 0::2]) ** 2, axis=1)
    else:
        p = 0.5 * (1 - w) * np.prod(
            4 * (w[:, None] - cos_lsp[None, 1::2]) ** 2, axis=1)
        q = 0.5 * (1 + w) * np.prod(4 * (w[:, None] - cos_lsp[None, 0::2]) ** 2, axis=1)
    amp_max = (1 << cfg.amplitude_bits) - 1
    linear = np.exp((amplitude * cfg.amplitude_offset /
                     (amp_max * np.sqrt(p + q)) - cfg.amplitude_offset)
                    * 0.11512925)
    return linear.astype(np.float32)


def _bark_map(cfg: FloorConfig0, n2: int) -> np.ndarray:
    def bark(x):
        return 13.1 * math.atan(0.00074 * x) + 2.24 * math.atan(1.85e-8 * x * x) \
            + 1e-4 * x

    rate = cfg.rate
    bms = cfg.bark_map_size
    foobar = bark(rate / 2.0)
    i = np.arange(n2)
    m = np.minimum(
        np.floor(np.array([bark(rate / 2.0 / n2 * x) for x in i]) * bms / foobar),
        bms - 1,
    ).astype(np.int64)
    return m * (np.pi / bms)
