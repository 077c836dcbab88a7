from easyav1.container.webm import WebMDemuxer, TrackInfo, Packet, TrackType  # noqa: F401
