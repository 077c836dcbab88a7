"""Device intra recon: residual assembly + sequential unit executor.

Implements the bridge contract (native av1_export_pred_units →
recon/exec_ref.py semantics) on device with JAX:

- Residual planes: dequantized coefficients, grouped by (tx_size,
  tx_type), run through the bit-exact batched inverse transforms
  (itx_jax) and scatter-added into padded mi-aligned planes.
- Intra prediction: one lax.scan per plane over pred units in decode
  order.  Every unit processes a fixed-size window (64 luma / 32
  chroma) with masks, so the scan body is one static program; all
  irregular decisions arrive precomputed in the unit records.  Luma
  runs first, then chroma (CfL reads the finished luma plane).

Planes carry a PAD px top/left margin and an ES px bottom/right margin
so dynamic slices never clamp; unit coordinates are pre-shifted by PAD.
Margin pixels are junk by construction and never read: edge fetches are
index-clamped to the mi-aligned extent (F_MAXXR/F_MAXYR) exactly like
the C recon clamps to pw-1/ph-1.

Correctness contract: bit-exact vs exec_ref.UnitExecutor (tested), and
therefore vs the native C recon.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List

import numpy as np

from easyav1.video.av1 import tables as T

PAD = 8          # top/left margin in the padded planes
NF = 30          # fields per preprocessed unit record

(F_X, F_Y, F_W, F_H, F_CLS, F_ANGLE, F_HA, F_HL, F_HTR, F_HBL,
 F_SA, F_SL, F_UA, F_UL, F_CF, F_ALPHA, F_ACX, F_ACY, F_ACW, F_ACH,
 F_DX, F_DY, F_MAXXR, F_MAXYR, F_NPXA, F_NPXL, F_NA, F_NL, F_VALID,
 F_RES) = range(NF)

K_DC, K_V, K_H, K_Z1, K_Z2, K_Z3, K_SM, K_SMV, K_SMH, K_PAETH, \
    K_CFL, K_ZERO, K_FILT, K_IBC = range(14)

_SM_OFFS = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}


def _tables():
    d = np.load(T.__file__.replace("tables.py", "tables_data.npz"))
    return d["dr_intra_derivative"], d["sm_weights"]


def pad_dims(ph: int, pw: int, ws: int):
    es = 2 * ws + 8
    return ph + PAD + es, pw + PAD + es


def preprocess_units(units: np.ndarray, dims,
                     pad: int = PAD) -> List[np.ndarray]:
    """Bridge records [N,24] → per-plane field arrays [Np, NF] int32
    (decode order preserved within each plane; coordinates shifted by
    PAD).  Class-9 records are filter-intra units whose `ang` column
    carries the filter mode (export_tx)."""
    dr, _ = _tables()
    out = []
    for plane in range(len(dims)):
        sel = units[units[:, 0] == plane]
        n = sel.shape[0]
        f = np.zeros((n, NF), np.int32)
        (x, y, w, h, cls, ang, ha, hl, htr, hbl, sa, sl, ua, ul, cf,
         alpha, acx, acy, acw, ach) = (sel[:, i] for i in range(1, 21))
        ph, pw = dims[plane]
        k = np.select(
            [cls == 0, cls == 1, cls == 2,
             (cls == 3) & (ang < 90), (cls == 3) & (ang > 180),
             cls == 3, cls == 4, cls == 5, cls == 6, cls == 7,
             cls == 8, cls == 10, cls == 9, cls == 11],
            [K_DC, K_V, K_H, K_Z1, K_Z3, K_Z2, K_SM, K_SMV, K_SMH,
             K_PAETH, K_CFL, K_ZERO, K_FILT, K_IBC])
        dx = np.zeros(n, np.int32)
        dy = np.zeros(n, np.int32)
        z1 = k == K_Z1
        z2 = k == K_Z2
        z3 = k == K_Z3
        dx[z1] = dr[ang[z1]]
        dx[z2] = dr[180 - ang[z2]]
        dy[z2] = dr[ang[z2] - 90]
        dy[z3] = dr[270 - ang[z3]]
        # intrabc (cls 11): src coords of the dynamic-slice window
        # (col in `ang`, row in `cf`; taps ride sa/sl/ua/ul)
        ibc = k == K_IBC
        dx[ibc] = ang[ibc] - 3 + pad
        dy[ibc] = cf[ibc] - 3 + pad
        f[:, F_X] = x + pad
        f[:, F_Y] = y + pad
        f[:, F_W] = w
        f[:, F_H] = h
        f[:, F_CLS] = k
        f[:, F_ANGLE] = ang
        f[:, F_HA] = ha
        f[:, F_HL] = hl
        f[:, F_HTR] = htr
        f[:, F_HBL] = hbl
        f[:, F_SA] = sa
        f[:, F_SL] = sl
        f[:, F_UA] = ua
        f[:, F_UL] = ul
        f[:, F_CF] = cf
        f[:, F_ALPHA] = alpha
        f[:, F_ACX] = acx + pad
        f[:, F_ACY] = acy + pad
        f[:, F_ACW] = acw
        f[:, F_ACH] = ach
        f[:, F_DX] = dx
        f[:, F_DY] = dy
        f[:, F_MAXXR] = (pw - 1) - x
        f[:, F_MAXYR] = (ph - 1) - y
        is_dir = z1 | z2 | z3
        f[:, F_NPXA] = np.where(
            is_dir,
            np.minimum(w, pw - x) + np.where(ang < 90, h, 0) + 1, 0)
        f[:, F_NPXL] = np.where(
            is_dir,
            np.minimum(h, ph - y) + np.where(ang > 180, w, 0) + 1, 0)
        f[:, F_NA] = w + np.where(htr != 0, w, 0)
        f[:, F_NL] = h + np.where(hbl != 0, h, 0)
        f[:, F_VALID] = 1
        # interintra blend pack (u[23]; 0 = plain unit) rides in F_RES
        f[:, F_RES] = sel[:, 23]
        out.append(f)
    return out


def _pad_pow2(a: np.ndarray, min_n: int = 1) -> np.ndarray:
    n = max(a.shape[0], 1, min_n)
    b = 1
    while b < n:
        b <<= 1
    if b == a.shape[0]:
        return a
    pad = np.zeros((b - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


def group_txs(txs: np.ndarray, coeffs: np.ndarray):
    """Coded-tx records → {(tx_size, tx_type): (coeff[N,ah,aw], plane,
    x, y)} with batch padded to pow2 (pad entries: zero coeffs at
    (0,0) plane 0 → zero residual, harmless scatter-add).  Returns
    None if any tx is lossless (WHT not on device yet).

    Vectorized (argsort + boundary split): the per-tx Python loop cost
    ~170 ms/frame at 1080p — ~half the host time of the device pipe."""
    if txs.shape[0] == 0:
        return {}
    if np.any(txs[:, 7] != 0):
        return None
    pl_a, xs_a, ys_a = txs[:, 0], txs[:, 1], txs[:, 2]
    tsz_a, ttyp_a, coff_a = txs[:, 3], txs[:, 4], txs[:, 6]
    key = tsz_a * 16 + ttyp_a
    order = np.argsort(key, kind="stable")
    ks = key[order]
    bounds = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1], True])
    out = {}
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        idx = order[b0:b1]
        ts, tt = int(tsz_a[idx[0]]), int(ttyp_a[idx[0]])
        adj = T.ADJUSTED_TX_SIZE[ts]
        ah, aw = T.TX_HEIGHT[adj], T.TX_WIDTH[adj]
        n = idx.shape[0]
        co = coeffs[coff_a[idx, None] + np.arange(ah * aw)] \
            .reshape(n, ah, aw).astype(np.int32, copy=False)
        # raw counts: the fused composer pads to its own sticky caps
        # (padded itx work is the dominant device cost, so no pow2
        # pre-inflation here)
        out[(ts, tt)] = (co, pl_a[idx].astype(np.int32),
                         xs_a[idx].astype(np.int32),
                         ys_a[idx].astype(np.int32))
    return out


# ------------------------------------------------------------------ #

class ResidualPlanner:
    """Gather-compose of batched itx outputs via a shared value buffer.

    Residual blocks tile each plane disjointly, so the composition is
    expressible without scatters: every (tx_size, tx_type) group runs
    its batched bit-exact itx and writes the flattened result into a
    FIXED-size device value buffer at a dynamic offset
    (lax.dynamic_update_slice on a donated buffer — in place), then
    each plane is composed with a single gather through a per-frame
    int32 slot map (0 = no residual).

    Shape stability: the value buffer length is a static function of
    the frame geometry (2x the plane pixels bounds any pow2-padded
    batch total), the gather jit is keyed only by the plane dims, and
    the small per-(tx_size, tx_type, n_pow2) writer kernels converge
    after a few frames — no frame-dependent mega-jit signatures, so no
    recompile storms when the tx mix shifts between frames.

    Mirrors dav1d's role split where itx writes into the frame buffer
    directly (recon_tmpl.c); here everything stays dense (batched
    itx matmuls + one gather per plane).
    """

    def __init__(self, layouts, np_, bd, lpad):
        self.layouts = layouts          # [(hp, wp, nstrips)] per plane
        self.np_ = np_
        self.bd = bd
        self.lpad = lpad
        tot = sum(hp * wp for (hp, wp, _) in layouts[:np_])
        # bound: actual residual pixels <= tot; ladder padding adds
        # < 8 blocks per (size, type) pair — sum of 7*h*w over every
        # legal pair is < 2M px
        self.vtotal = tot + 2_000_000 + 65536

    def build(self, txs, coeffs):
        """-> (groups, maps) or None (lossless present).
        groups: [(ts, tt, co[n_pow2, ah, aw], offset)]."""
        maps = [np.zeros((hp, wp), np.int32)
                for (hp, wp, _) in self.layouts[:self.np_]]
        if txs.shape[0] == 0:
            return [], maps
        if np.any(txs[:, 7] != 0):
            return None                  # lossless (WHT) not on device
        pl, xs, ys = txs[:, 0], txs[:, 1], txs[:, 2]
        tsz, ttyp, coff = txs[:, 3], txs[:, 4], txs[:, 6]
        key = tsz * 16 + ttyp
        order = np.argsort(key, kind="stable")
        ks = key[order]
        bounds = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1], True])

        groups = []
        off = 1                          # slot 0 = no residual
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            idx = order[b0:b1]
            ts, tt = int(tsz[idx[0]]), int(ttyp[idx[0]])
            adj = T.ADJUSTED_TX_SIZE[ts]
            ah, aw = T.TX_HEIGHT[adj], T.TX_WIDTH[adj]
            h, w = T.TX_HEIGHT[ts], T.TX_WIDTH[ts]
            n = idx.shape[0]
            co = coeffs[coff[idx, None] + np.arange(ah * aw)] \
                .reshape(n, ah, aw).astype(np.int32, copy=False)
            blk = np.arange(h * w, dtype=np.int32).reshape(h, w)
            slots = (off + np.arange(n, dtype=np.int32)[:, None, None]
                     * (h * w) + blk[None])
            ii = ys[idx, None, None] + np.arange(h)[None, :, None]
            jj = (xs[idx, None, None] + self.lpad
                  + np.arange(w)[None, None, :])
            for p in range(self.np_):
                m = pl[idx] == p
                if not np.any(m):
                    continue
                hp, wp, _ = self.layouts[p]
                np.put(maps[p].reshape(-1),
                       (ii[m].astype(np.int64) * wp + jj[m]).ravel(),
                       slots[m].ravel())
            # decompose into the pair's static pow4 chunk ladder: the
            # kernel shapes never depend on this frame's n, so new XLA
            # compiles happen only the first time a (size, type) pair
            # appears in the stream — never on later frames
            padded = (n + 7) & ~7
            if padded > n:
                co = np.concatenate(
                    [co, np.zeros((padded - n, ah, aw), np.int32)])
            pos = 0
            for csz in _chunk_ladder(h * w):
                while padded - pos >= csz:
                    groups.append((ts, tt, co[pos:pos + csz], off))
                    pos += csz
                    off += csz * h * w
        if off > self.vtotal:
            return None                  # can't happen by construction
        return groups, maps

    def compose(self, txs, coeffs):
        """-> [resid plane device arrays] or None."""
        import jax.numpy as jnp
        built = self.build(txs, coeffs)
        if built is None:
            return None
        groups, maps = built
        vals = jnp.zeros(self.vtotal, jnp.int32)
        for ts, tt, co, off in groups:
            k = _itx_write_kernel(ts, tt, co.shape[0], self.bd,
                                  self.vtotal)
            vals = k(vals, jnp.asarray(co), off)
        kern = _gather_kernel(tuple((hp, wp) for (hp, wp, _)
                                    in self.layouts[:self.np_]),
                              self.vtotal)
        return list(kern(vals, [jnp.asarray(m) for m in maps]))


_PLANNERS: Dict[tuple, "ResidualPlanner"] = {}


def get_planner(layouts, np_, bd, lpad) -> ResidualPlanner:
    key = (tuple(layouts), np_, bd, lpad)
    pl = _PLANNERS.get(key)
    if pl is None:
        pl = _PLANNERS[key] = ResidualPlanner(layouts, np_, bd, lpad)
    return pl


@functools.lru_cache(maxsize=None)
def _chunk_ladder(px_per_block: int):
    """Static pow4 chunk sizes (in blocks) for a tx size: largest chunk
    targets ~512K px, smallest is 8 blocks; any 8-aligned count
    decomposes exactly (base-4 digits)."""
    top = 8
    while top * px_per_block < 512 * 1024:
        top *= 4
    sizes = []
    c = top
    while c >= 8:
        sizes.append(c)
        c //= 4
    return tuple(sizes)


@functools.lru_cache(maxsize=None)
def _itx_write_kernel(ts, tt, n, bd, vtotal):
    """jit: (vals[vtotal], co[n,ah,aw], offset) -> vals with the
    batch's itx outputs written at [offset : offset + n*h*w]."""
    import jax
    import jax.numpy as jnp
    from easyav1.video.av1.recon.itx_jax import _make_kernel

    ki = _make_kernel(ts, tt, bd)

    def fn(vals, co, off):
        return jax.lax.dynamic_update_slice(
            vals, ki(co).reshape(-1), (off,))

    return jax.jit(fn, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def _gather_kernel(dims, vtotal):
    """jit: (vals, maps) -> [vals[maps[p]] for p]."""
    import jax

    def fn(vals, maps):
        return [vals[maps[p]] for p in range(len(dims))]

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _residual_multi_kernel(sig, bitdepth, nplanes, pad_y=PAD,
                           pad_x=PAD):
    """One fused jit for EVERY coefficient bucket of a frame: the
    per-(tx,type) ladder (10-25 dispatches/frame) collapses into one
    dispatch.  sig = sorted
    tuple of (tx_size, tx_type, n_cap); buckets padded to sticky pow2
    caps keep the signature stable across frames."""
    import jax
    import jax.numpy as jnp
    from easyav1.video.av1.recon.itx_jax import _make_kernel

    kerns = [(_make_kernel(ts, tt, bitdepth), T.TX_HEIGHT[ts],
              T.TX_WIDTH[ts]) for (ts, tt, _n) in sig]

    def fn(planes, args):
        for (ki, h, w), (co, pl, xs, ys) in zip(kerns, args):
            res = ki(co)
            ii = jnp.arange(h)[None, :, None]
            jj = jnp.arange(w)[None, None, :]
            yy = ys[:, None, None] + pad_y + ii
            xx = xs[:, None, None] + pad_x + jj
            for p in range(nplanes):
                m = (pl == p)[:, None, None]
                planes[p] = planes[p].at[yy, xx].add(
                    jnp.where(m, res, 0), mode="drop")
        return planes

    return jax.jit(fn, donate_argnums=(0,))


def compose_residual_host(txs, coeffs, shapes, pad_y, pad_x, bd):
    """Host-C itx into fresh int32 planes (av1_compose_residual).
    Returns numpy planes or None when the native library is absent
    (caller falls back to the device composer).  EASYAV1_HOST_RESID=0
    forces the device composer."""
    import ctypes

    import easyav1.native as nat
    if os.environ.get("EASYAV1_HOST_RESID", "1") == "0":
        return None                  # A/B: force the device composer
    lib = nat._load()
    if lib is None or not hasattr(lib, "av1_compose_residual"):
        return None
    use_i16 = bd <= 10
    dt = np.int16 if use_i16 else np.int32
    planes = [np.zeros(s, dt) for s in shapes]
    if txs.shape[0]:
        from easyav1.native import _vp
        ptrs = (ctypes.c_void_p * len(planes))(
            *[p.ctypes.data for p in planes])
        strides = np.asarray([p.shape[1] for p in planes], np.int32)
        hs = np.asarray([p.shape[0] for p in planes], np.int32)
        txs_c = np.ascontiguousarray(txs, np.int32)
        co_c = np.ascontiguousarray(coeffs, np.int32)
        lib.av1_compose_residual(_vp(txs_c), ctypes.c_int64(
            txs.shape[0]), _vp(co_c), ptrs, _vp(strides), _vp(hs),
            pad_y, pad_x, bd, int(use_i16))
    return planes


def apply_literals(planes, literals, pad_y, pad_x):
    """Fold palette-prediction patches (av1_export_literal_preds) into
    the composed residual planes: cls-10 units then reconstruct as
    clip(0 + (palette + residual)).  Safe in int16: |residual| <=
    2^(bd+3) and palette <= 2^bd-1 stay far from the int16 limits."""
    recs, pix = literals
    for k in range(recs.shape[0]):
        p, x, y, w, h, off = (int(v) for v in recs[k])
        patch = pix[off:off + w * h].reshape(h, w)
        tgt = planes[p][y + pad_y:y + pad_y + h,
                        x + pad_x:x + pad_x + w]
        tgt += patch.astype(tgt.dtype)


_RESID_CAPS: dict = {}


def apply_residuals_fused(planes, groups, bd, nplanes, pad_y=PAD,
                          pad_x=PAD):
    """Pad each bucket to its sticky cap and run the fused kernel.
    Invalid pad rows scatter far outside the plane (mode='drop').
    The kernel signature is the sticky bucket-set + caps, not the
    frame's exact tx mix: it only changes when a NEW (size, type)
    bucket first appears or a cap grows, which settles within a few
    frames of a stream, so steady state compiles nothing."""
    import jax.numpy as jnp
    # grow the sticky bucket set first: the signature is the UNION of
    # every bucket ever seen (absent buckets ship zero batches), so it
    # only changes when a brand-new (size, type) appears — a per-frame
    # "present buckets" signature would recompile whenever the tx mix
    # shifts between frames
    for (tsz, ttyp), (co, _pl, _xs, _ys) in groups.items():
        key = (tsz, ttyp)
        cap = _RESID_CAPS.get(key, 0)
        n = co.shape[0]
        if n > cap:
            # 25% slack, 64-aligned (NOT pow2): padded itx work is the
            # dominant device cost, so tight caps beat round shapes;
            # grow-only means a full warm pass absorbs every recompile
            cap = max(8, -(-(n + (n >> 2)) // 64) * 64)
            _RESID_CAPS[key] = cap
    sig = []
    args = []
    for (tsz, ttyp), cap in sorted(_RESID_CAPS.items()):
        adj = T.ADJUSTED_TX_SIZE[tsz]
        ah, aw = T.TX_HEIGHT[adj], T.TX_WIDTH[adj]
        cop = np.zeros((cap, ah, aw), np.int32)
        plp = np.zeros(cap, np.int32)
        xsp = np.zeros(cap, np.int32)
        ysp = np.full(cap, 1 << 20, np.int32)   # pad rows: dropped
        g = groups.get((tsz, ttyp))
        if g is not None:
            co, pl, xs, ys = g
            n = co.shape[0]
            cop[:n] = co
            plp[:n] = pl
            xsp[:n] = xs
            ysp[:n] = ys
        sig.append((tsz, ttyp, cap))
        args.append((jnp.asarray(cop), jnp.asarray(plp),
                     jnp.asarray(xsp), jnp.asarray(ysp)))
    kern = _residual_multi_kernel(tuple(sig), bd, nplanes, pad_y,
                                  pad_x)
    return kern(planes, args)


@functools.lru_cache(maxsize=None)
def _residual_kernel(tx_size, tx_type, n, bitdepth, nplanes,
                     pad_y=PAD, pad_x=PAD):
    """jit: scatter-add a batch of itx outputs into padded planes."""
    import jax
    import jax.numpy as jnp
    from easyav1.video.av1.recon.itx_jax import _make_kernel

    h = T.TX_HEIGHT[tx_size]
    w = T.TX_WIDTH[tx_size]
    kern_inner = _make_kernel(tx_size, tx_type, bitdepth)

    def fn(planes, co, pl, xs, ys):
        res = kern_inner(co)                  # [n, h, w] int32
        ii = jnp.arange(h)[None, :, None]
        jj = jnp.arange(w)[None, None, :]
        yy = ys[:, None, None] + pad_y + ii
        xx = xs[:, None, None] + pad_x + jj
        outp = []
        for p in range(nplanes):
            m = (pl == p)[:, None, None]
            contrib = jnp.where(m, res, 0)
            outp.append(planes[p].at[yy, xx].add(contrib, mode="drop"))
        return outp

    return jax.jit(fn, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def _scan_kernel(ws: int, ph: int, pw: int, bitdepth: int,
                 with_cfl: bool, ssx: int, ssy: int, n_masks: int = 0):
    """jit: fn(plane_pad, resid_pad, fields[, luma_pad][, masks]) ->
    plane_pad.

    Sequential executor over unit records for one plane.  Bit-exact
    mirror of exec_ref._unit with fixed [ws, ws] windows + masks.
    n_masks > 0 adds a masks[n_masks, ws, ws] input: a unit whose
    F_RES pack is nonzero blends its intra prediction against the
    CURRENT window (the staged inter pred) with mask[F_RES>>24?] —
    the interintra compound (av1_mc.h interintra_blend role); F_RES
    then carries the 1-based mask-stack index."""
    import jax
    import jax.numpy as jnp

    _, sm_np = _tables()
    ES = 2 * ws + 8
    mxpix = (1 << bitdepth) - 1
    base = 1 << (bitdepth - 1)
    sm = jnp.asarray(sm_np.astype(np.int32))
    sm_off = jnp.asarray(
        np.array([_SM_OFFS.get(1 << i, 0) for i in range(7)], np.int32))
    from easyav1.video.av1 import tables as _T
    fi_taps = jnp.asarray(
        np.asarray(_T.data()["filter_intra_taps"], np.int32))

    iota = jnp.arange(ES, dtype=jnp.int32)
    ii = jnp.arange(ws, dtype=jnp.int32)[:, None]
    jj = jnp.arange(ws, dtype=jnp.int32)[None, :]

    # edge layout: slot 0 spare (base -2 after upsample), slot 1 =
    # corner (base -1), slot 2+k = pixel k
    def eidx(b):
        return jnp.clip(2 + b, 0, ES - 1)

    kerns = jnp.asarray(np.array(
        [[0, 0, 16, 0, 0], [0, 4, 8, 4, 0], [0, 5, 6, 5, 0],
         [2, 4, 4, 4, 2]], np.int32))

    def edge_filter(edge, sz, strength, active):
        """5-tap smoothing over view [corner, px...] = slots 1..;
        element 0 of the view (corner) kept.  sz includes the corner."""
        view = edge[1:]                        # [ES-1], v[0] = corner
        n = ES - 1
        io = jnp.arange(n, dtype=jnp.int32)
        kern = kerns[jnp.clip(strength, 0, 3)]
        acc = jnp.zeros(n, jnp.int32)
        for t in range(5):
            k = jnp.clip(io - 2 + t, 0, sz - 1)
            acc = acc + kern[t] * view[k]
        filt = (acc + 8) >> 4
        keep = (io < 1) | (io >= sz) | (strength == 0) \
            | jnp.logical_not(active)
        view = jnp.where(keep, view, filt)
        return edge.at[1:].set(view)

    def upsample(edge, num_px, do):
        """Spec upsample_intra_edge on the slot layout: after it,
        slot 0 = old corner, slot 1 = s[0], slot 2+k =
        (px[k//2] if k odd-free...).  new px[2i] = px[i],
        new px[2i-1] = s[i] (s[0] lands in the corner slot)."""
        io = jnp.arange(ES + 3, dtype=jnp.int32)
        corner = edge[1]
        # dup[k]: k==0,1 -> corner; 2..num_px+1 -> px[k-2] (clamped);
        # num_px+2 -> px[num_px-1]
        pxi = jnp.clip(io - 2, 0, jnp.maximum(num_px - 1, 0))
        dup = jnp.where(io < 2, corner, edge[eidx(pxi)])
        s = -dup[:ES] + 9 * dup[1:ES + 1] + 9 * dup[2:ES + 2] \
            - dup[3:ES + 3]
        s = jnp.clip((s + 8) >> 4, 0, mxpix)     # s[i], i = 0..
        # rebuild: slot0 = corner, slot1 = s[0],
        # slot 2+k: k even -> px[k//2], k odd -> s[(k+1)//2]
        k = iota - 2
        even = (k & 1) == 0
        newpx = jnp.where(even, edge[eidx(k >> 1)],
                          s[jnp.clip((k + 1) >> 1, 0, ES - 1)])
        # positions past the written run (k > 2*num_px-2) keep the
        # ORIGINAL edge values — the C upsample leaves them untouched
        # and zone2 can read one past the run
        newpx = jnp.where(k <= 2 * num_px - 2, newpx, edge[eidx(k)])
        out = edge.at[0].set(corner).at[1].set(s[0]).at[2:].set(
            newpx[2:])
        return jnp.where(do, out, edge)

    def log2i(v):
        # FLOOR log2 (spec bit_length-1): CfL ac blocks clipped at the
        # frame edge have non-pow2 dims (e.g. 12) and the avg shift
        # uses the floor — float log2 + rounding breaks exactness
        return 31 - jax.lax.clz(jnp.maximum(v, 1).astype(jnp.int32))

    def make_body(resid, luma):
        def body(plane, f):
            x = f[F_X]
            y = f[F_Y]
            w = f[F_W]
            h = f[F_H]
            cls = f[F_CLS]
            ha = f[F_HA] != 0
            hl = f[F_HL] != 0
            valid = f[F_VALID] != 0

            arow = jax.lax.dynamic_slice(plane, (y - 1, x - 1),
                                         (1, ES))[0]
            lcol = jax.lax.dynamic_slice(plane, (y - 1, x - 1),
                                         (ES, 1))[:, 0]
            ia = jnp.minimum(jnp.minimum(iota, f[F_NA] - 1),
                             f[F_MAXXR])
            above_px = arow[jnp.clip(1 + ia, 0, ES - 1)]
            il = jnp.minimum(jnp.minimum(iota, f[F_NL] - 1),
                             f[F_MAXYR])
            left_px = lcol[jnp.clip(1 + il, 0, ES - 1)]
            fill_a = jnp.where(hl, lcol[1], base - 1)
            fill_l = jnp.where(ha, arow[1], base + 1)
            above_px = jnp.where(ha, above_px, fill_a)
            left_px = jnp.where(hl, left_px, fill_l)
            corner = jnp.where(
                ha & hl, arow[0],
                jnp.where(ha, arow[1], jnp.where(hl, lcol[1], base)))

            above = jnp.zeros(ES, jnp.int32).at[2:].set(
                above_px[:ES - 2]).at[1].set(corner).at[0].set(corner)
            left = jnp.zeros(ES, jnp.int32).at[2:].set(
                left_px[:ES - 2]).at[1].set(corner).at[0].set(corner)

            is_dir = (cls == K_Z1) | (cls == K_Z2) | (cls == K_Z3)
            cf = (f[F_CF] != 0) & is_dir
            cs = (left[2] * 5 + above[1] * 6 + above[2] * 5 + 8) >> 4
            above = above.at[1].set(jnp.where(cf, cs, above[1]))
            above = above.at[0].set(above[1])
            left = left.at[1].set(jnp.where(cf, cs, left[1]))
            left = left.at[0].set(left[1])

            above = edge_filter(above, f[F_NPXA], f[F_SA],
                                is_dir & ha)
            left = edge_filter(left, f[F_NPXL], f[F_SL],
                               is_dir & hl)

            ua = (f[F_UA] != 0) & is_dir
            ul = (f[F_UL] != 0) & is_dir
            nup_a = w + jnp.where(f[F_ANGLE] < 90, h, 0)
            nup_l = h + jnp.where(f[F_ANGLE] > 180, w, 0)
            above = upsample(above, nup_a, ua)
            left = upsample(left, nup_l, ul)

            A = above[2:]
            L = left[2:]
            corner2 = above[1]

            def d_zone1():
                up = f[F_UA]
                max_base = (w + h - 1) << up
                idx = (ii + 1) * f[F_DX]
                bb = (idx >> (6 - up)) + (jj << up)
                shift = jnp.broadcast_to(((idx << up) >> 1) & 0x1F,
                                         (ws, ws))
                b = jnp.minimum(bb, max_base)
                e0 = above[eidx(b)]
                e1 = above[eidx(jnp.minimum(b + 1, max_base + 1))]
                v = (e0 * (32 - shift) + e1 * shift + 16) >> 5
                return jnp.where(bb >= max_base, above[eidx(max_base)],
                                 v)

            def d_zone3():
                up = f[F_UL]
                max_base = (w + h - 1) << up
                idy = (jj + 1) * f[F_DY]
                bb = (idy >> (6 - up)) + (ii << up)
                shift = jnp.broadcast_to(((idy << up) >> 1) & 0x1F,
                                         (ws, ws))
                b = jnp.minimum(bb, max_base)
                e0 = left[eidx(b)]
                e1 = left[eidx(jnp.minimum(b + 1, max_base + 1))]
                v = (e0 * (32 - shift) + e1 * shift + 16) >> 5
                return jnp.where(bb >= max_base, left[eidx(max_base)],
                                 v)

            def d_zone2():
                upa = f[F_UA]
                upl = f[F_UL]
                idx = (jj << 6) - (ii + 1) * f[F_DX]
                bb = idx >> (6 - upa)
                sh_a = ((idx << upa) >> 1) & 0x1F
                ba = jnp.maximum(bb, -2)
                va = (above[eidx(ba)] * (32 - sh_a)
                      + above[eidx(ba + 1)] * sh_a + 16) >> 5
                idy = (ii << 6) - (jj + 1) * f[F_DY]
                by = idy >> (6 - upl)
                sh_l = ((idy << upl) >> 1) & 0x1F
                bl = jnp.maximum(by, -2)
                vl = (left[eidx(bl)] * (32 - sh_l)
                      + left[eidx(bl + 1)] * sh_l + 16) >> 5
                return jnp.where(bb >= -(1 << upa), va, vl)

            def p_dc():
                suma = jnp.sum(jnp.where(jj[0] < w, A[:ws], 0))
                suml = jnp.sum(jnp.where(ii[:, 0] < h, L[:ws], 0))
                both = ha & hl
                num = jnp.where(both, suma + suml,
                                jnp.where(ha, suma, suml))
                den = jnp.where(both, w + h, jnp.where(ha, w, h))
                avg = jnp.where(
                    ha | hl,
                    (num + (den >> 1)) // jnp.maximum(den, 1), base)
                return jnp.full((ws, ws), avg, jnp.int32)

            def p_v():
                return jnp.broadcast_to(A[:ws][None, :], (ws, ws))

            def p_h():
                return jnp.broadcast_to(L[:ws][:, None], (ws, ws))

            def p_paeth():
                b = A[:ws][None, :]
                ll = L[:ws][:, None]
                p = b + ll - corner2
                pb = jnp.abs(p - b)
                pl = jnp.abs(p - ll)
                pc = jnp.abs(p - corner2)
                return jnp.where((pl <= pb) & (pl <= pc), ll,
                                 jnp.where(pb <= pc, b, corner2))

            def smw(n, idx):
                off = sm_off[jnp.clip(log2i(n), 0, 6)]
                return sm[jnp.clip(off + idx, 0, sm.shape[0] - 1)]

            def p_smooth():
                wy = smw(h, jnp.minimum(ii, h - 1))
                wx = smw(w, jnp.minimum(jj, w - 1))
                below = L[jnp.clip(h - 1, 0, ES - 3)]
                right = A[jnp.clip(w - 1, 0, ES - 3)]
                num = wy * A[jnp.clip(jj, 0, ES - 3)] \
                    + (256 - wy) * below \
                    + wx * L[jnp.clip(ii, 0, ES - 3)] \
                    + (256 - wx) * right
                return (num + 256) >> 9

            def p_smooth_v():
                wy = smw(h, jnp.minimum(ii, h - 1))
                below = L[jnp.clip(h - 1, 0, ES - 3)]
                return (wy * A[jnp.clip(jj, 0, ES - 3)]
                        + (256 - wy) * below + 128) >> 8

            def p_smooth_h():
                wx = smw(w, jnp.minimum(jj, w - 1))
                right = A[jnp.clip(w - 1, 0, ES - 3)]
                return (wx * L[jnp.clip(ii, 0, ES - 3)]
                        + (256 - wx) * right + 128) >> 8

            def p_zero():
                # literal unit (palette): the block's palette
                # prediction is pre-folded into the residual plane by
                # the host composer; pred contributes nothing
                return jnp.zeros((ws, ws), jnp.int32)

            def p_filt():
                # recursive filter intra (spec 7.11.2.3, parity:
                # recon_ref._filter_intra_pred): 4x2 patches in raster
                # order from 7 neighbors; W buffer row 0 / col 0 hold
                # the unfiltered edges, f[F_ANGLE] carries the mode
                taps = fi_taps[jnp.clip(f[F_ANGLE], 0, 4)]  # [8, 8]
                WB = jnp.zeros((ws + 2, ws + 8), jnp.int32)
                arow_w = jnp.concatenate(
                    [corner2[None], A[:ws + 7]]).astype(jnp.int32)
                WB = WB.at[0, :].set(arow_w)
                lcol_w = jnp.concatenate(
                    [corner2[None], L[:ws + 1]]).astype(jnp.int32)
                WB = WB.at[:, 0].set(lcol_w)
                n_w = (w + 3) >> 2
                n_h = (h + 1) >> 1

                def patch(s, WB):
                    i = s // 8
                    j = s - 8 * i
                    y0 = 2 * i
                    x0 = 4 * j
                    act = (i < n_h) & (j < n_w)
                    top = jax.lax.dynamic_slice(WB, (y0, x0),
                                                (1, 5))[0]
                    lft = jax.lax.dynamic_slice(WB, (y0 + 1, x0),
                                                (2, 1))[:, 0]
                    p = jnp.concatenate(
                        [top, lft, jnp.zeros(1, jnp.int32)])  # [8]
                    v = jnp.einsum("kp,p->k", taps, p,
                                   preferred_element_type=jnp.int32)
                    v = jnp.clip((v + 8) >> 4, 0, mxpix)
                    blk = v.reshape(2, 4)
                    cur = jax.lax.dynamic_slice(
                        WB, (y0 + 1, x0 + 1), (2, 4))
                    blk = jnp.where(act, blk, cur)
                    return jax.lax.dynamic_update_slice(
                        WB, blk, (y0 + 1, x0 + 1))

                # filter-intra blocks are at most 32x32: 16 patch
                # rows x 8 patch cols of 4x2 sub-blocks
                WB = jax.lax.fori_loop(0, 128, patch, WB)
                return jax.lax.dynamic_slice(WB, (1, 1), (ws, ws))

            def p_ibc():
                # intra block copy (spec 5.11.19 / av1_mc.h
                # predict_inter_i32): whole-pel DV, so at most the two
                # bilinear phases 3/4 are live; the sequential scan
                # guarantees the source rect is already reconstructed.
                # F_DX/F_DY = padded src - 3; taps ride F_SA..F_UL.
                win = jax.lax.dynamic_slice(
                    plane, (f[F_DY], f[F_DX]), (ws + 8, ws + 8))
                mid = (f[F_SA] * win[:, 3:3 + ws]
                       + f[F_SL] * win[:, 4:4 + ws] + 4) >> 3
                v = (f[F_UA] * mid[3:3 + ws, :]
                     + f[F_UL] * mid[4:4 + ws, :] + 1024) >> 11
                return jnp.clip(v, 0, mxpix)

            pred = jax.lax.switch(
                jnp.clip(cls, 0, 13),
                [p_dc, p_v, p_h, d_zone1, d_zone2, d_zone3, p_smooth,
                 p_smooth_v, p_smooth_h, p_paeth, p_dc, p_zero,
                 p_filt, p_ibc])

            if with_cfl:
                lx = (f[F_ACX] - PAD) * (1 + ssx) + PAD
                ly = (f[F_ACY] - PAD) * (1 + ssy) + PAD
                lblk = jax.lax.dynamic_slice(
                    luma, (ly, lx), (2 * ws, 2 * ws))
                if ssx and ssy:
                    v = (lblk[0::2, 0::2] + lblk[0::2, 1::2]
                         + lblk[1::2, 0::2] + lblk[1::2, 1::2]) << 1
                elif ssx:
                    v = (lblk[:ws, 0::2] + lblk[:ws, 1::2]) << 2
                else:
                    v = (lblk[:ws, :ws]) << 3
                acw = f[F_ACW]
                ach = f[F_ACH]
                acm = (jj < acw) & (ii < ach)
                tot = jnp.sum(jnp.where(acm, v, 0))
                log2sz = log2i(acw) + log2i(ach)
                avg = (tot + (1 << jnp.clip(log2sz - 1, 0, 30))) \
                    >> log2sz
                ac = v - avg
                offy = y - f[F_ACY]
                offx = x - f[F_ACX]
                acs = jax.lax.dynamic_slice(
                    jnp.pad(ac, ((0, ws), (0, ws))), (offy, offx),
                    (ws, ws))
                alpha = f[F_ALPHA]
                diff = alpha * acs
                scaled = jnp.sign(diff) * ((jnp.abs(diff) + 32) >> 6)
                incfl = (cls == K_CFL) & (alpha != 0) \
                    & (ii < (ach - offy)) & (jj < (acw - offx))
                pred = jnp.where(
                    incfl, jnp.clip(pred + scaled, 0, mxpix), pred)

            rwin = jax.lax.dynamic_slice(resid, (y, x), (ws, ws))
            cur = jax.lax.dynamic_slice(plane, (y, x), (ws, ws))
            if n_masks:
                midx = f[F_RES]
                mk = masks_ref[0][
                    jnp.clip(midx - 1, 0, n_masks - 1)]
                pred = jnp.where(midx > 0,
                                 (pred * mk + cur * (64 - mk) + 32)
                                 >> 6, pred)
            out = jnp.clip(pred + rwin, 0, mxpix)
            m = (ii < h) & (jj < w) & valid
            blended = jnp.where(m, out, cur)
            plane = jax.lax.dynamic_update_slice(plane, blended,
                                                 (y, x))
            return plane, 0

        return body

    masks_ref = [None]

    if with_cfl and n_masks:
        def fn(plane_pad, resid_pad, fields, luma_pad, masks):
            masks_ref[0] = masks
            body = make_body(resid_pad, luma_pad)
            plane, _ = jax.lax.scan(body, plane_pad, fields)
            return plane
    elif with_cfl:
        def fn(plane_pad, resid_pad, fields, luma_pad):
            body = make_body(resid_pad, luma_pad)
            plane, _ = jax.lax.scan(body, plane_pad, fields)
            return plane
    elif n_masks:
        def fn(plane_pad, resid_pad, fields, masks):
            masks_ref[0] = masks
            body = make_body(resid_pad, None)
            plane, _ = jax.lax.scan(body, plane_pad, fields)
            return plane
    else:
        def fn(plane_pad, resid_pad, fields):
            body = make_body(resid_pad, None)
            plane, _ = jax.lax.scan(body, plane_pad, fields)
            return plane

    return jax.jit(fn, donate_argnums=(0,))


# ------------------------------------------------------------------ #

class DeviceRecon:
    """Frame orchestrator for the device intra recon path."""

    def __init__(self, mi_rows, mi_cols, ssx, ssy, bitdepth=8,
                 num_planes=3):
        self.bd = bitdepth
        self.ssx, self.ssy = ssx, ssy
        self.np_ = num_planes
        aw, ah = mi_cols * 4, mi_rows * 4
        self.dims = [(ah, aw), (ah >> ssy, aw >> ssx),
                     (ah >> ssy, aw >> ssx)][:num_planes]
        self.ws = [64, 32, 32]

    def run(self, units: np.ndarray, txs: np.ndarray,
            coeffs: np.ndarray, literals=None):
        """Returns device arrays (padded planes) or None if the frame
        uses features the device path lacks (lossless, non-420
        CfL)."""
        import jax.numpy as jnp
        if self.np_ > 1 and not (self.ssx and self.ssy):
            if np.any(units[units[:, 0] > 0][:, 5] == 8):
                return None
        try:
            fields = preprocess_units(units, self.dims)
        except NotImplementedError:
            return None

        shapes = [pad_dims(*self.dims[p], self.ws[p])
                  for p in range(self.np_)]
        # residual planes share the padded plane geometry; margins are
        # only read through clamped indices
        rnp = compose_residual_host(txs, coeffs, shapes, PAD, PAD,
                                    self.bd)
        if literals is not None:
            if rnp is None:
                return None  # literal fold needs the host composer
            apply_literals(rnp, literals, PAD, PAD)
        if rnp is not None:
            resid = [jnp.asarray(r).astype(jnp.int32)
                     for r in rnp]
        else:
            # device composer: no WHT kernels — lossless needs the
            # host compose path (itx_wht4 handled there)
            if txs.shape[0] and np.any(txs[:, 7] != 0):
                return None
            groups = group_txs(txs, coeffs)
            if groups is None:
                return None
            resid = [jnp.zeros(s, jnp.int32) for s in shapes]
            if groups:
                resid = apply_residuals_fused(resid, groups, self.bd,
                                              self.np_)
        return self.predict(fields, resid)

    def predict(self, fields, resid):
        """Intra prediction of every plane over padded int32 residual
        planes: luma first, then chroma (CfL reads the finished luma).
        `fields` as from preprocess_units.  Returns padded planes."""
        import jax.numpy as jnp
        outs = []
        for p in range(self.np_):
            php, pwp = resid[p].shape
            kp = _scan_kernel(self.ws[p], php, pwp, self.bd, p > 0,
                              self.ssx, self.ssy)
            args = [jnp.zeros((php, pwp), jnp.int32), resid[p],
                    jnp.asarray(_pad_pow2(fields[p]))]
            outs.append(kp(*args, *outs[:1]))
        return outs

    def crop(self, outs):
        """Padded device planes → mi-aligned numpy planes."""
        res = []
        for p, o in enumerate(outs):
            ph, pw = self.dims[p]
            res.append(np.asarray(o)[PAD:PAD + ph, PAD:PAD + pw])
        return res
