from easyav1.audio.vorbis.decoder import VorbisDecoder  # noqa: F401
