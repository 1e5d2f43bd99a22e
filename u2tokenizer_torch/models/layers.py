"""Building blocks that stand in for ``flax.linen``'s ``Dense`` and
``LayerNorm``, with flax's semantics: parameters keep their own dtype and
every product runs in the module's compute ``dtype`` (flax's ``dtype``
argument), and LayerNorm's epsilon defaults to 1e-6 (torch's is 1e-5).

Every module with parameters has ``reset_parameters(generator)``, which
draws them from an explicit ``torch.Generator`` with the initializers the
JAX package names (the same distributions; torch's generator gives other
numbers than ``jax.random``); ``init_weights`` walks a model and calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# its std by it so that the truncated draw keeps the asked-for variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a normal with std (1/fan_in)^(1/2) / 0.8796...
    truncated to two of those stds, in place."""
    std = fan_in ** -0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class Dense(nn.Module):
    """y = x W^T + b in ``dtype``. ``weight`` is (out, in), torch's layout;
    flax's kernel is (in, out) and ``weights.load_flax_params`` transposes
    it. Init: flax's ``lecun_normal`` (``lecun_normal_``), zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in fp32, epsilon 1e-6, output in
    ``dtype``. Parameters are named ``weight``/``bias`` (flax: scale/bias)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Draw every parameter of ``model`` from one seeded generator on the
    model's device, module by module in registration order."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator)


@torch.no_grad()
def cast_for_inference(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast float parameters with ndim >= 2 to ``dtype`` and keep 1-D ones
    (norm weights, biases) in fp32, as the JAX package's
    ``quantize.cast_for_inference`` does. A module's ``keep_fp32`` names
    parameters that stay fp32 because it reads them in fp32 (the seg
    head's Fourier matrix), so that casting ahead of time changes no
    value."""
    for module in model.modules():
        keep = getattr(module, "keep_fp32", ())
        for name, param in module.named_parameters(recurse=False):
            if (param.is_floating_point() and param.ndim >= 2
                    and name not in keep):
                param.data = param.data.to(dtype)
    return model
