"""Serving entry points of the port."""

from m3f_torch.infer.predictor import (Predictor, SessionGroup,  # noqa: F401
                                       StreamingSession)
from m3f_torch.infer.server import PredictServer  # noqa: F401
