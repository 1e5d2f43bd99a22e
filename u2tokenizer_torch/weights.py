"""Move the JAX package's parameters into the port's modules.

``load_flax_params(model, flat)`` takes the flat dict that
``flax.traverse_util.flatten_dict(params["params"], sep="/")`` gives
(``{"a/b/c": array}``, numpy or any array numpy can read) and copies every
entry into the parameter of the same path. The port's module tree mirrors
the flax tree, so the path maps one to one, with three renames:

  * ``name_<i>`` (flax's list naming) -> ``name.<i>`` (an ``nn.ModuleList``);
  * a ``Dense`` kernel (in, out) -> ``weight`` (out, in), transposed; this
    holds for the int8 kernel of a quantized ``QDense`` too, while its
    packed int4 kernel (ng, g/2, out) keeps the JAX package's layout;
  * a ``LayerNorm`` ``scale`` -> ``weight``.

Every other leaf keeps its name and layout, the quantized trees' ``scale``
and ``embed_scale`` included. Integer leaves (the int8 and packed int4
kernels, the int8 embedding table) are copied as integers and float leaves
are cast to each parameter's float dtype; a model built without quantized
weights refuses a quantized tree. The load is strict: an entry with no
parameter, a shape or kind (integer or float) that differs, or a parameter
left unfilled raises.

``flax_path`` maps the other way, so that a trainable filter written for
the JAX package's gradient paths (``fn("params/vision_tower/...") ->
bool``, as ``train/sft.py`` and ``cli train`` use it) selects the same
parameters of the port (``trainable_names``), and ``flax_params`` gives a
model's parameters as the JAX package's nested tree (what
``models.hf_export`` exports). ``flatten`` turns such a tree, as
``models.hf_weights`` converts it, into the flat dict this module loads.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from .models.layers import Dense, LayerNorm

_LIST_ITEM = re.compile(r"(.+)_(\d+)$")


def torch_name(flax_path: str, modules: Mapping[str, nn.Module]):
    """Flax parameter path -> (torch parameter name, transpose?)."""
    *parents, leaf = flax_path.split("/")
    parts = []
    for part in parents:
        m = _LIST_ITEM.match(part)
        prefix = ".".join(parts + [m.group(1)]) if m else None
        if m and isinstance(modules.get(prefix), nn.ModuleList):
            parts += [m.group(1), m.group(2)]
        else:
            parts.append(part)
    owner = modules.get(".".join(parts))
    transpose = False
    if leaf == "kernel" and isinstance(owner, Dense):
        leaf, transpose = "weight", owner.weight.dim() == 2
    elif leaf == "scale" and isinstance(owner, LayerNorm):
        leaf = "weight"
    return ".".join(parts + [leaf]), transpose


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """A nested parameter tree -> ``{"a/b/c": leaf}``, as flax's
    ``flatten_dict(tree, sep="/")``; a tree with a top-level ``"params"``
    is flattened below it."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten(value, path))
        else:
            flat[path] = value
    return flat


@torch.no_grad()
def load_flax_params(model: nn.Module, flat: Mapping[str, object]) -> None:
    """Copy every entry of ``flat`` into its parameter, one at a time."""
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    filled = set()
    for path, value in flat.items():
        name, transpose = torch_name(path, modules)
        if name not in params:
            raise KeyError(f"{path}: the port has no parameter {name!r}")
        arr = np.asarray(value)
        if arr.dtype.kind not in "biu":  # float leaves, bf16 included
            arr = arr.astype(np.float32, copy=False)
        src = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        if transpose:
            src = src.t()
        dst = params[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} does not fit "
                             f"{name} {tuple(dst.shape)}")
        if src.is_floating_point() != dst.is_floating_point():
            raise TypeError(f"{path}: {src.dtype} does not fit {name} "
                            f"{dst.dtype} (quantized weights need a model "
                            "built with cfg.llm.quantized_weights)")
        dst.copy_(src.to(dtype=dst.dtype, device=dst.device))
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"parameters with no flax counterpart: {missing}")


def flax_path(name: str, modules: Mapping[str, nn.Module]) -> str:
    """Torch parameter name -> the path the JAX package's train step hands
    its trainable filter: ``"params/"`` + the flax path."""
    *parents, leaf = name.split(".")
    parts = []
    for i, part in enumerate(parents):
        if part.isdigit() and isinstance(modules.get(".".join(parents[:i])),
                                         nn.ModuleList):
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    owner = modules.get(".".join(parents))
    if leaf == "weight" and isinstance(owner, Dense):
        leaf = "kernel"
    elif leaf == "weight" and isinstance(owner, LayerNorm):
        leaf = "scale"
    return "/".join(["params", *parts, leaf])


@torch.no_grad()
def flax_params(model: nn.Module) -> dict:
    """The model's parameters as the JAX package's ``{"params": ...}`` tree
    of host numpy arrays: float leaves in fp32, quantized ones as they are,
    ``Dense`` kernels as (in, out) views of the (out, in) weights."""
    modules = dict(model.named_modules())
    tree: dict = {}
    for name, p in model.named_parameters():
        *parents, leaf = flax_path(name, modules).split("/")[1:]
        arr = p.detach().cpu()
        arr = (arr.float() if arr.is_floating_point() else arr).numpy()
        owner = modules.get(name.rsplit(".", 1)[0])
        if isinstance(owner, Dense) and leaf == "kernel" and arr.ndim == 2:
            arr = arr.T
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return {"params": tree}


def trainable_names(model: nn.Module,
                    trainable_filter: Callable[[str], bool]) -> List[str]:
    """The parameter names of ``model`` whose flax path the filter keeps."""
    modules = dict(model.named_modules())
    return [name for name, _ in model.named_parameters()
            if trainable_filter(flax_path(name, modules))]
