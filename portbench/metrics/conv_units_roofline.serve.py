"""The fused conv units' least time (rows 3-4, from the forwards' shapes) over their device time (%)."""

from portbench.readers import conv_units_roofline_serve as read  # noqa: F401
