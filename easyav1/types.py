"""Output frame types mirroring easyav1_video_frame / easyav1_audio_frame
(/root/reference/src/easyav1.h:288-319)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np

from easyav1.settings import (
    BitsPerColor, ChromaSamplePosition, ColorPrimaries, ColorSpace,
    MatrixCoefficients, PixelLayout, TransferCharacteristics,
)


@dataclasses.dataclass
class VideoFrameProperties:
    pixel_layout: PixelLayout = PixelLayout.UNKNOWN
    bits_per_color: BitsPerColor = BitsPerColor.UNKNOWN
    color_space: ColorSpace = ColorSpace.UNKNOWN
    color_primaries: ColorPrimaries = ColorPrimaries.UNSPECIFIED
    transfer_characteristics: TransferCharacteristics = (
        TransferCharacteristics.UNSPECIFIED)
    matrix_coefficients: MatrixCoefficients = MatrixCoefficients.UNSPECIFIED
    chroma_sample_position: ChromaSamplePosition = ChromaSamplePosition.UNKNOWN
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class VideoFrame:
    """Decoded video frame: YUV planes as numpy arrays (stride implicit in
    the array layout; data[2] shares chroma geometry with data[1], parity
    easyav1.c:3561-3563)."""

    properties: VideoFrameProperties
    timestamp: int  # ms
    data: List[np.ndarray]  # [y, u, v] (u/v absent for monochrome)

    @property
    def stride(self) -> List[int]:
        return [p.strides[0] for p in self.data]


@dataclasses.dataclass
class AudioFrame:
    """Decoded audio frame (easyav1.h:309-319): float32 PCM, either
    interleaved (samples, channels) flattened or per-channel list."""

    channels: int
    samples: int
    timestamp: int  # ms
    pcm: Union[np.ndarray, List[np.ndarray]]  # interlaced or deinterlaced

    @property
    def bytes(self) -> int:
        if isinstance(self.pcm, list):
            return self.samples * 4
        return self.samples * self.channels * 4
