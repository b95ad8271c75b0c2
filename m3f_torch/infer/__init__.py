"""Serving entry points of the port."""

from m3f_torch.infer.predictor import Predictor  # noqa: F401
