"""Model FLOPs of the clips trained (forward and backward) over the window, against the peak in the model's precision (%)."""

from portbench.readers import mfu_train as read  # noqa: F401
