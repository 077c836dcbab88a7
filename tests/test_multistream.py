"""Multi-stream batched decode (BASELINE config 5 shape) on the
virtual device mesh: N real AV1 streams, production entropy decode +
recon per stream, one mesh-sharded vmapped LF+CDEF postfilter step —
each stream bit-exact vs its ordinary single-stream decode."""

import jax
import pytest

from easyav1.parallel.mesh import make_mesh
from easyav1.parallel.multistream_av1 import run_multistream


def test_multistream_real_decode_dp():
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh(n, tp=1)
    assert run_multistream(mesh, n_streams=n) == n


def test_multistream_more_streams_than_devices():
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh(n, tp=1)
    assert run_multistream(mesh, n_streams=2 * n) == 2 * n


def test_multistream_real_fixtures_dp():
    """Config-5 at real-stream scale (scaled-down geometry for CPU):
    N real WebM fixtures, C entropy+recon on host, one vmapped
    dp-sharded LF+CDEF step per frame across all streams — bit-exact
    vs each stream's ordinary native decode."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from fixtures import make_fixture
    from easyav1.parallel.multistream_av1 import run_multistream_real

    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh(min(n, 4), tp=1)
    paths = [make_fixture(w=320, h=180, fps=30, frames=2, gop=1, crf=30
                          + 4 * s, audio_secs=0, content=1)
             for s in range(4)]
    ns, total, wall = run_multistream_real(mesh, paths, max_frames=2)
    assert ns == 4 and total == 8
