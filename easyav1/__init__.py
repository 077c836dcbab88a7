"""easyav1 — a WebM/AV1/Vorbis playback framework in JAX and C.

A from-scratch rebuild of the capabilities of crudelios/easyav1
(reference: src/easyav1.h of that project):

* Host (Python/numpy + C++): stream I/O, EBML/WebM container demux,
  Vorbis header + symbol decode, AV1 OBU parse + msac entropy decode,
  seek state machine, the public API.
* Device (JAX/XLA, on a GPU): all dense math — Vorbis IMDCT + windowed
  overlap-add, AV1 inverse transforms, intra prediction, motion
  compensation, deblocking, CDEF, loop restoration, film grain.

Public API mirrors the reference's ``easyav1.h`` surface
(easyav1.h:449-822): see :class:`easyav1.api.EasyAV1`.
"""

from easyav1.settings import (  # noqa: F401
    EasyAV1Settings,
    EasyAV1Status,
    LogLevel,
    default_settings,
)
from easyav1.api import (  # noqa: F401
    EasyAV1,
    init_from_custom_stream,
    init_from_file,
    init_from_filename,
    init_from_memory,
)

__version__ = "0.1.0"
