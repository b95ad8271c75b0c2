"""The fused conv units' least time (rows 3-8: forward, data and filter gradients) over their device time (%)."""

from portbench.readers import conv_units_roofline_train as read  # noqa: F401
