"""Reconstruction kernels of the device path (JAX/XLA).

SURVEY.md §7 device side: the dense per-pixel math — inverse
transforms, loop filter, CDEF — runs under jit, batched over the
frame's transform blocks with a static shape menu.  The numpy *_ref
modules remain the bit-exact conformance oracles.
"""

from easyav1.video.av1.recon.itx_jax import itx_batch  # noqa: F401
