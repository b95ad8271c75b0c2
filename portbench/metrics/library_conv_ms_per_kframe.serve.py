"""Device ms of the library's convolutions per 1000 frames scored."""

from portbench.readers import library_conv_ms_per_kframe as read  # noqa: F401
