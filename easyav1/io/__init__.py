from easyav1.io.stream import Stream, FileStream, MemoryStream, CustomStream  # noqa: F401
