"""Device ms a train step outside the port's own kernels."""

from portbench.readers import other_device_ms_per_step as read  # noqa: F401
