"""Train-time augmentation of face-crop clips, on the batch's device.

Counterpart of ``m3f/pytorch_tpu/ops/augment.py``: per example, a
horizontal flip with ``flip_prob``, a pixel scale U(1 - contrast,
1 + contrast) and a pixel shift U(-brightness, brightness), clipped back to
[0, 1]. Each decision is the example's and is shared by all its windows
and frames (flipping or brightening some frames of a clip only would break
its motion and identity).

The draws (``augment_draws``) are kept apart from the arithmetic
(``apply_augment``), so that a test can feed in the reference's draws. The
reference's random stream itself cannot be matched; the port draws from a
``torch.Generator`` that the trainer seeds from ``(train.seed, step)``, so
a resumed run augments exactly as an uninterrupted one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from m3f_torch.parallel.mesh import global_rows


def augment_draws(b: int, *, flip_prob: float, brightness: float,
                  contrast: float, generator: Optional[torch.Generator],
                  device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flip [b] bool, scale [b] fp32, shift [b] fp32) from ``generator``,
    always in that order and all three, whatever the knobs."""
    u = torch.rand(3, b, generator=generator, device=device)
    flip = u[0] < flip_prob
    scale = (1.0 - contrast) + (2.0 * contrast) * u[1]
    shift = -brightness + (2.0 * brightness) * u[2]
    return flip, scale, shift


def apply_augment(video: torch.Tensor, flip: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor, *,
                  brightness: float, contrast: float,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """video [B, W, L, H, W', 3] uint8 (or float in [0, 1]) → the compute
    dtype in [0, 1], in the reference's rounding order, each step one
    rounding: cast, /255 (uint8 input), flip of the width axis, * scale
    (cast to the compute dtype; skipped when ``contrast`` is 0), + shift
    (likewise; skipped when ``brightness`` is 0), clip."""
    v = video.to(compute_dtype)
    if video.dtype == torch.uint8:
        v = v / 255.0
    expand = (slice(None),) + (None,) * (video.ndim - 1)
    v = torch.where(flip[expand], v.flip(-2), v)
    if contrast:
        v = v * scale[expand].to(compute_dtype)
    if brightness:
        v = v + shift[expand].to(compute_dtype)
    return torch.clamp(v, 0.0, 1.0)


def augment_clips(video: torch.Tensor, *, flip_prob: float = 0.5,
                  brightness: float = 0.1, contrast: float = 0.1,
                  compute_dtype=torch.bfloat16,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Augment a [B, W, L, H, W', 3] batch with draws from ``generator`` (a
    generator on the batch's device; None: the global stream). Within a
    data-parallel step the draws are the global batch's, and this rank
    keeps its rows, so the ranks draw what one process draws for the whole
    batch."""
    n, rows = global_rows(video.shape[0])
    flip, scale, shift = augment_draws(
        n, flip_prob=flip_prob, brightness=brightness,
        contrast=contrast, generator=generator, device=video.device)
    return apply_augment(video, flip[rows], scale[rows], shift[rows],
                         brightness=brightness, contrast=contrast,
                         compute_dtype=compute_dtype)
