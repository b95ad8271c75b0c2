"""Model FLOPs of the windows scored over the window, against the peak in the model's precision (%)."""

from portbench.readers import mfu_serve as read  # noqa: F401
