"""Multi-chip scaling: batched multi-stream decode over a jax Mesh.

The reference is strictly single-process (SURVEY.md §2g); its only
parallelism is host threads + SIMD. The device scaling story
(BASELINE.json config 5: 8 concurrent 1080p streams) is a *batch axis
over streams*, sharded over a device mesh:

* ``dp`` (data-parallel): independent media streams — no cross-talk.
* ``tp`` (tensor-parallel): the dense per-stream math is contracted over
  its inner dimension (IMDCT spectral bins; superblock columns for
  video), with a psum over ``tp`` combining partial products.

This module provides the audio instance (multi-stream Vorbis synthesis).
The AV1 recon pipeline reuses the same mesh layout.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from easyav1.audio.vorbis.decoder import build_window, imdct_matrix


def make_mesh(n_devices: int, tp: int = 2) -> Mesh:
    """A (dp, tp) mesh over the first n_devices devices.  Every card
    reaches every other at the same rate, so the layout follows the
    algorithm only: tp = 1 when it does not divide n_devices."""
    devs = np.array(jax.devices()[:n_devices])
    if n_devices % tp:
        tp = 1
    return Mesh(devs.reshape(n_devices // tp, tp), ("dp", "tp"))


class MultiStreamVorbisSynth:
    """S concurrent streams, each a chunk of B blocks, synthesized in one
    pjit'd step: streams sharded over dp, IMDCT contraction split over tp.
    """

    def __init__(self, mesh: Mesh, streams: int, channels: int,
                 n0: int, n1: int, chunk: int = 16):
        self.mesh = mesh
        self.S = streams
        self.ch = channels
        self.n0 = n0
        self.n1 = n1
        self.B = chunk
        self.P_pad = n1
        self.BUF = self.P_pad + chunk * (n1 // 2) + n1

        wins = np.zeros((6, n1), np.float64)
        wins[0, :n0] = build_window(n0, n0, n1, False, 0, 0)
        wins[1] = build_window(n1, n0, n1, True, 0, 0)
        wins[2] = build_window(n1, n0, n1, True, 0, 1)
        wins[3] = build_window(n1, n0, n1, True, 1, 0)
        wins[4] = build_window(n1, n0, n1, True, 1, 1)
        self._windows = jnp.asarray(wins, jnp.float32)
        self._imdct1 = jnp.asarray(imdct_matrix(n1), jnp.float32)
        self._step = self._build()

    def _build(self):
        mesh = self.mesh
        S, B, ch, n1 = self.S, self.B, self.ch, self.n1
        n2 = n1 // 2
        BUF, Ppad = self.BUF, self.P_pad
        windows = self._windows
        imdct1 = self._imdct1
        tp_size = mesh.shape["tp"]
        assert n2 % tp_size == 0, "spectral dim must divide tp"

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P("dp", None, None, "tp"), P("dp", None, None, "tp"),
                      P("dp", None), P("dp", None), P("dp", None, None)),
            out_specs=P("dp", None, None),
        )
        def step(spec, floor, window_ids, offsets, cache):
            """spec/floor: (S/dp, B, ch, n2/tp); ids/offsets: (S/dp, B);
            cache: (S/dp, ch, n2). Returns (S/dp, ch, BUF)."""
            s_local = spec.shape[0]
            k_local = spec.shape[-1]
            tp_idx = jax.lax.axis_index("tp")
            # TP: local partial IMDCT over this shard's spectral rows,
            # combined with a psum over the tp axis.
            rows = jax.lax.dynamic_slice_in_dim(
                imdct1, tp_idx * k_local, k_local, axis=0)
            x = (spec * floor).reshape(s_local * B * ch, k_local)
            partial = jnp.matmul(x, rows,
                                 precision=jax.lax.Precision.HIGHEST)
            pcm = jax.lax.psum(partial, "tp").reshape(s_local, B, ch, n1)
            win = windows[window_ids]  # (s_local, B, n1)
            pcm = pcm * win[:, :, None, :]

            buf = jnp.zeros((s_local, ch, BUF), jnp.float32)
            buf = jax.lax.dynamic_update_slice(buf, cache, (0, 0, Ppad))

            def body(k, buf):
                def per_stream(b, off, block):
                    cur = jax.lax.dynamic_slice(b, (0, off), (ch, n1))
                    return jax.lax.dynamic_update_slice(b, cur + block, (0, off))

                return jax.vmap(per_stream)(buf, offsets[:, k], pcm[:, k])

            buf = jax.lax.fori_loop(0, B, body, buf)
            return buf

        return jax.jit(step)

    def step(self, spec, floor, window_ids, offsets, cache):
        """One synthesis step. spec/floor: (S, B, ch, n1//2) float32;
        window_ids/offsets: (S, B) int32; cache: (S, ch, n1//2)."""
        return self._step(spec, floor, window_ids, offsets, cache)

    def example_inputs(self, rng: np.random.Generator):
        S, B, ch, n2 = self.S, self.B, self.ch, self.n1 // 2
        spec = rng.standard_normal((S, B, ch, n2)).astype(np.float32)
        floor = np.abs(rng.standard_normal((S, B, ch, n2))).astype(np.float32)
        wids = np.full((S, B), 1, np.int32)
        offsets = (self.P_pad + np.arange(B, dtype=np.int32) * (self.n1 // 2)
                   )[None].repeat(S, 0) - self.n1 // 2
        offsets = np.maximum(offsets, 0).astype(np.int32)
        cache = np.zeros((S, ch, n2), np.float32)
        return spec, floor, wids, offsets, cache
