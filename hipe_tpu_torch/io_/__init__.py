"""Host I/O: the libjpeg codec (entropy layer of the device JPEG codec)."""
