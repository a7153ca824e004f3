"""Snake periodic activations (port of `dmel_codec_tpu/nn/snake.py`).

snake(x)      = x + (1/(alpha+eps)) * sin^2(alpha x)
snake_beta(x) = x + (1/(beta +eps)) * sin^2(alpha x)

With `logscale` the stored parameters are log-alpha/log-beta. Channels-first:
alpha/beta [C] broadcast over [B, C, T].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

_EPS = 1e-9


def snake_coefficients(
    alpha: torch.Tensor, beta: Optional[torch.Tensor], logscale: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, 1 / (beta + eps)) as the activation applies them, exp'd under
    `logscale`; beta=None is plain snake (gain 1/alpha). Computed in the
    parameters' dtype, as the JAX package computes them (nn/snake.py,
    ops/anti_alias.py:607-612, ops/stage_fused.py pack_stage): a bf16
    parameter gives bf16-rounded values."""
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta) if beta is not None else None
    return alpha, 1.0 / ((alpha if beta is None else beta) + _EPS)


def snake(x: torch.Tensor, alpha: torch.Tensor, logscale: bool = False) -> torch.Tensor:
    return snake_beta(x, alpha, None, logscale)


def snake_beta(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    logscale: bool = False,
) -> torch.Tensor:
    """beta=None is plain snake (gain 1/alpha)."""
    alpha, gain = snake_coefficients(alpha, beta, logscale)
    s = torch.sin(x * alpha[:, None])
    return x + gain[:, None] * s * s


class Snake(nn.Module):
    """The plain snake activation with its one parameter `alpha` [features]."""

    def __init__(self, features: int, alpha_logscale: bool = False):
        super().__init__()
        self.features = features
        self.alpha_logscale = alpha_logscale
        init = torch.zeros if alpha_logscale else torch.ones
        self.alpha = nn.Parameter(init(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha, self.alpha_logscale)


class SnakeBeta(nn.Module):
    """Parameter holder with the reference's `alpha` / `beta` names (beta is
    absent for plain snake); ops/anti_alias applies it."""

    def __init__(self, channels: int, activation: str = "snakebeta", logscale: bool = True):
        super().__init__()
        if activation not in ("snake", "snakebeta"):
            raise ValueError(f"unknown activation {activation!r}")
        init = torch.zeros if logscale else torch.ones
        self.logscale = logscale
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if activation == "snakebeta" else None
