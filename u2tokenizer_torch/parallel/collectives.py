"""Collectives over a mesh dim's process group (counterpart of
``u2tokenizer_tpu/parallel/collectives.py``).

The JAX package's three helpers run inside ``shard_map`` over a named mesh
axis; here each takes the process group of a mesh dim (``Mesh.group(name)``
of ``parallel.mesh``; None is the whole world) and acts on this rank's
tensor:

  * ``all_gather_features`` -- the ranks' tensors concatenated along dim 0
    (``tiled``) or stacked on a new dim 0, with gradients: a
    ``torch.autograd.Function`` whose backward is JAX's VJP of a tiled
    ``all_gather``, the cotangents summed over the group and each rank
    given its own slice (a reduce-scatter);
  * ``reduce_dict`` -- the mean (``average``) or the sum of a dict of
    tensors over the group, in one all-reduce;
  * ``global_batch_mean`` -- the mean over the local batch, then over the
    group.

The megatron region operators of the decoder's tensor parallelism
(``models/llm/decoder.py``) live here too; they have no counterpart in the
JAX package, where GSPMD inserts the collectives:

  * ``copy_to_group``: identity forward, gradients summed over the group
    (before a column-parallel product);
  * ``reduce_from_group``: summed over the group forward, identity
    backward (after a row-parallel product);
  * ``gather_last_from_group``: the ranks' slices concatenated along the
    last dim forward, this rank's slice of the gradient backward;
  * ``split_last_to_group``: this rank's slice of the last dim forward,
    the gradients concatenated backward.

Every rank of a tensor group computes the same loss from the same rows, so
these backwards give each rank the full gradient of its own parameters and
nothing is summed over the tensor dim afterwards. Sums of bf16 tensors
run in fp32 and round once, as one product over the whole contraction
would.
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch
import torch.distributed as dist


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: x summed over the group (fp32 for a bf16 or fp16
    tensor, then rounded back)."""
    out = x.float() if x.dtype in (torch.bfloat16, torch.float16) else \
        x.clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's tensors (each x's shape) concatenated along ``dim`` in
    rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def own_slice(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's 1/size of ``dim`` (contiguous)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def reduce_scatter_flat(flat: torch.Tensor, group=None) -> torch.Tensor:
    """A 1-D tensor, whose length the group's size divides, summed over the
    group; this rank's contiguous 1/size of it."""
    out = flat.new_empty(flat.numel() // dist.get_world_size(group))
    with warnings.catch_warnings():  # renamed in later torch releases
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out


def all_gather_flat(shard: torch.Tensor, group=None) -> torch.Tensor:
    """The group's 1-D shards concatenated in rank order."""
    out = shard.new_empty(shard.numel() * dist.get_world_size(group))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


class _AllGatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tiled):
        ctx.group, ctx.tiled = group, tiled
        return all_gather_dim(x if tiled else x.unsqueeze(0), 0, group)

    @staticmethod
    def backward(ctx, grad):
        summed = all_reduce_sum(grad, ctx.group)
        mine = own_slice(summed, 0, ctx.group)
        return (mine if ctx.tiled else mine.squeeze(0)), None, None


def all_gather_features(x: torch.Tensor, group=None,
                        tiled: bool = True) -> torch.Tensor:
    """Gather the ranks' feature shards along dim 0 with gradients flowing
    back to every shard (the reference's gather_with_grad,
    dist_utils.py:280-306; ``lax.all_gather`` in the JAX package)."""
    return _AllGatherFeatures.apply(x, group, tiled)


def reduce_dict(metrics: Dict[str, torch.Tensor], group=None,
                average: bool = True) -> Dict[str, torch.Tensor]:
    """Each value (a scalar or any tensor) summed over the group, or
    averaged with ``average``, in one fp32 all-reduce (the reference's
    reduce_dict, dist_utils.py:247-276)."""
    keys = list(metrics)
    values = [torch.as_tensor(metrics[k]) for k in keys]
    if not values:
        return {}
    device = values[0].device
    flat = torch.cat([v.detach().float().reshape(-1).to(device)
                      for v in values])
    dist.all_reduce(flat, group=group)
    if average:
        flat = flat / dist.get_world_size(group)
    out, at = {}, 0
    for k, v in zip(keys, values):
        out[k] = flat[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return out


def global_batch_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the local batch, then over the group's ranks."""
    return reduce_dict({"x": x.float().mean()}, group)["x"]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        return own_slice(grad, -1, ctx.group), None


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return own_slice(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, -1, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_last_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherLast.apply(x, group)


def split_last_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _SplitLast.apply(x, group)
