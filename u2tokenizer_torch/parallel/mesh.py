"""The (data, fsdp, tensor) mesh and its parameter placements on
``torch.distributed`` (counterpart of ``u2tokenizer_tpu/parallel/mesh.py``).

The JAX package runs one program over every device and lets GSPMD place
tensors from ``NamedSharding`` annotations. The port runs one process a
card (``torchrun``), each holding its part of the state and running the
step on its own rows; the collectives are explicit. ``make_mesh`` gives
rank r the coordinates that ``np.asarray(devices).reshape(data, fsdp,
tensor)`` gives device r in the JAX package, and a process group for every
dim and pair of dims.

The rule table ``_PARAM_RULES``, ``param_pspec`` and the divisibility
fallback ``_fixed_pspec`` are the JAX package's, copied as data over flax
paths and (in, out) kernels; ``placements`` maps them onto the port's
parameter names and (out, in) weights through the weight bridge's name map
(``weights.flax_path``) and derives each parameter's ``Placement``:

  * ``tensor_dim``: the torch dim that a rule splits over 'tensor' (the
    column-parallel q/k/v/gate/up weights on their output dim, the
    row-parallel o/down weights and the LM head on their input dim, the
    embedding table on its vocabulary dim); each tensor rank holds and
    computes with its own slice (``models/llm/decoder.py`` under
    ``shard_decoder``). The bias of a column-parallel projection follows its
    weight's output dim;
  * ``fsdp``: a rule names 'fsdp' on one of its dims. These parameters and
    their AdamW state are stored flat and sharded over the fsdp dim (ZeRO-3
    at rest, FSDP padding at the end), gathered for the step and sharded
    again after it (``train/sft.make_sharded_trainer``);
  * 'data' replicates; every other parameter is replicated over data and
    fsdp, as the JAX package replicates it.

``batch_rows`` gives ``data_sharding``'s counterpart: rank (d, f, t) takes
rows [k*b, (k+1)*b) of a global batch with k = d*fsdp + f, so the ranks of
one tensor group see the same rows.

Known differences from the JAX package: GSPMD may split q/k/v columns in
the middle of a head when 'tensor' does not divide the kv heads; the port
raises a ``ValueError`` naming both. ``activation_mesh`` and
``batch_sharded_activation`` only steer GSPMD's activation layouts and are
not ported: each rank's program already holds its own rows.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import MeshConfig

AXES = ("data", "fsdp", "tensor")

# (regex over the flattened flax param path, PartitionSpec as a tuple: one
# entry a dim, None, an axis name, or a tuple of axis names) -- first match
# wins. The JAX package's table, word for word.
_PARAM_RULES: Tuple[Tuple[str, tuple], ...] = (
    # decoder embedding (vocab, hidden): megatron vocab-parallel
    (r"embed_tokens$", (("fsdp", "tensor"), None)),
    # attention in-projections (hidden, heads*hd): column parallel
    (r"(q_proj|k_proj|v_proj)/kernel$", ("fsdp", "tensor")),
    # attention out-projection (heads*hd, hidden): row parallel
    (r"o_proj/kernel$", ("tensor", "fsdp")),
    # mlp
    (r"(gate_proj|up_proj)/kernel$", ("fsdp", "tensor")),
    (r"down_proj/kernel$", ("tensor", "fsdp")),
    # lm head (hidden, vocab)
    (r"lm_head/kernel$", ("tensor", "fsdp")),
    # μ²tokenizer attentions: column/row pairs over fsdp
    (r"(wq|wk|wv)/kernel$", (None, "fsdp")),
    (r"dense/kernel$", ("fsdp", None)),
    # token-selection scorer: replicate
    (r"score_net/kernel$", ()),
    # vision / projector dense kernels: FSDP over the input dim
    (r"(qkv|out_proj|proj|mlp_fc1|mlp_fc2|"
     r"projector_\d+|linear)/kernel$", ("fsdp", None)),
)


def param_pspec(path: str, ndim: int) -> tuple:
    """PartitionSpec (as a tuple) for a parameter given its flattened flax
    path and rank. 1D params (norm scales, biases) replicate."""
    if ndim <= 1:
        return ()
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            if len(spec) <= ndim:
                return spec
    return ()


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _fixed_pspec(mesh_shape: Dict[str, int], path: str, shape) -> tuple:
    """Rule-derived PartitionSpec, divisibility-checked: any dimension not
    divisible by its mesh axis falls back to replication on that axis."""
    p = param_pspec(path, len(shape))
    axes = list(p) + [None] * (len(shape) - len(p))
    fixed = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            fixed.append(None)
        else:
            size = int(np.prod([mesh_shape[a] for a in _axes(ax)]))
            fixed.append(ax if dim % size == 0 else None)
    return tuple(fixed)


@dataclass
class Mesh:
    """This rank's place in a (data, fsdp, tensor) mesh: ``coords`` by dim
    name and the process groups of ``group(name)``."""

    cfg: MeshConfig
    rank: int
    device: torch.device
    coords: Dict[str, int]
    groups: Dict[str, object]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.cfg.data, "fsdp": self.cfg.fsdp,
                "tensor": self.cfg.tensor}

    def size(self, name: str) -> int:
        """The size of a dim, or of a pair of dims ("data,fsdp")."""
        return int(np.prod([self.shape[a] for a in name.split(",")]))

    def group(self, name: str):
        """The process group of the ranks that differ from this one along
        the dim ``name`` only ("data", "fsdp", "tensor"), or along a pair
        ("data,fsdp": the ranks that hold the other rows of the global
        batch, one tensor rank each); "world" for every rank."""
        return self.groups[name]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def batch_rows(self, global_rows: int) -> slice:
        """This rank's rows of a global batch of ``global_rows``."""
        n = self.size("data,fsdp")
        if global_rows % n:
            raise ValueError(f"a global batch of {global_rows} rows does not "
                             f"split over data x fsdp = {n}")
        b = global_rows // n
        k = self.coords["data"] * self.cfg.fsdp + self.coords["fsdp"]
        return slice(k * b, (k + 1) * b)


# the groups a mesh keeps: a name, and the dims its ranks differ along
_GROUPS = (("data", ("data",)), ("fsdp", ("fsdp",)), ("tensor", ("tensor",)),
           ("data,fsdp", ("data", "fsdp")))


def make_mesh(cfg: Optional[MeshConfig] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the ranks of the initialised default process group.
    With no config every rank goes on the data dim; a config whose device
    count is not the world size raises. Every rank must call it (it makes
    the groups, each on every rank, in one order)."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    if cfg is None:
        cfg = MeshConfig(data=world)
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg} wants {cfg.num_devices} devices, "
                         f"have {world}")
    grid = np.arange(world).reshape(cfg.data, cfg.fsdp, cfg.tensor)
    where = np.argwhere(grid == rank)[0]
    coords = dict(zip(AXES, (int(i) for i in where)))
    groups: Dict[str, object] = {"world": dist.group.WORLD}
    for name, dims in _GROUPS:
        moving = [AXES.index(d) for d in dims]
        # every group of this kind, on every rank, in one order
        lines = np.moveaxis(grid, moving, list(range(3 - len(moving), 3)))
        lines = lines.reshape(-1, int(np.prod([grid.shape[i]
                                               for i in moving])))
        for ranks in lines:
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[name] = g
    return Mesh(cfg, rank, torch.device(device or "cpu"), coords, groups)


# ---------------------------------------------------------------------------
# parameter placements
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Placement:
    """Where a parameter lives: split over 'tensor' along ``tensor_dim``
    (None: whole on every tensor rank) and flat-sharded over 'fsdp'."""

    tensor_dim: Optional[int]
    fsdp: bool


def torch_pspec(modules: Dict[str, nn.Module], name: str, shape,
                mesh_shape) -> tuple:
    """The divisibility-checked PartitionSpec of the port's parameter
    ``name`` (of the model whose ``named_modules()`` are ``modules``) over
    its torch dims: the JAX rule at its flax path, on its flax shape, with
    a Dense kernel's (in, out) read as (out, in)."""
    from ..models.layers import Dense
    from ..weights import flax_path

    owner = modules.get(name.rsplit(".", 1)[0])
    dense = isinstance(owner, Dense) and name.endswith(".weight") and \
        len(shape) == 2
    flax_shape = tuple(reversed(shape)) if dense else tuple(shape)
    spec = _fixed_pspec(mesh_shape, flax_path(name, modules), flax_shape)
    return tuple(reversed(spec)) if dense else spec


def placements(model: nn.Module, mesh_shape: Dict[str, int]
               ) -> Dict[str, Placement]:
    """Every parameter's ``Placement`` from the rule table, on the whole
    (unsplit) model."""
    out = {}
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        spec = torch_pspec(modules, name, tuple(p.shape), mesh_shape)
        tdim = next((i for i, e in enumerate(spec) if "tensor" in _axes(e)),
                    None)
        if mesh_shape["tensor"] == 1:
            tdim = None
        fsdp = any("fsdp" in _axes(e) for e in spec) and mesh_shape["fsdp"] > 1
        out[name] = Placement(tdim, fsdp)
    for name, place in list(out.items()):
        # a column-parallel projection's bias follows its output columns
        if name.endswith(".weight") and place.tensor_dim == 0:
            bias = name[:-len("weight")] + "bias"
            if bias in out:
                out[bias] = Placement(0, out[bias].fsdp)
    return out


def shard_decoder(model: nn.Module, mesh: Mesh,
                  places: Dict[str, Placement]) -> set:
    """Split the decoder over the mesh's tensor dim in place: every
    parameter with a ``tensor_dim`` keeps this rank's slice of it, and the
    attention (its local heads), MLP, embedding and untied head modules
    whose weights were split get the tensor group
    (``models/llm/decoder.py``). Returns the names of the whole parameters
    that act on this rank's heads only (the per-head q/k norms), whose
    gradients are partial sums over the tensor group. Raises for a decoder
    the port cannot split as the JAX package's rules do."""
    from ..models.llm.decoder import MLP, Attention, CausalLM, DecoderModel

    t = mesh.cfg.tensor
    split = {n for n, p in places.items() if p.tensor_dim is not None}
    if t == 1 or not split:
        return set()
    llm = next(m for m in model.modules() if isinstance(m, CausalLM))
    cfg = llm.cfg
    if cfg.num_kv_heads % t:
        raise ValueError(
            f"mesh tensor={t} does not divide the decoder's num_kv_heads="
            f"{cfg.num_kv_heads}: the port splits whole heads (the JAX "
            "package's GSPMD splits the k/v columns mid-head)")
    if cfg.quantized_weights or cfg.lora_rank:
        raise ValueError("a tensor mesh splits float weights: quantized or "
                         "LoRA decoders train on one card (--qlora)")
    group, rank = mesh.group("tensor"), mesh.coords["tensor"]

    def is_split(prefix: str, *names: str) -> bool:
        got = {f"{prefix}.{n}.weight" in split for n in names}
        if len(got) > 1:
            raise ValueError(f"{prefix}: the rules split only some of "
                             f"{names} over 'tensor'")
        return got.pop()

    claimed, partial = set(), set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, Attention) and is_split(
                prefix, "q_proj", "k_proj", "v_proj", "o_proj"):
            mod.tp_group = group
            mod.num_heads //= t
            mod.num_kv_heads //= t
            claimed |= {f"{prefix}.{n}.{w}" for n in ("q_proj", "k_proj",
                                                      "v_proj", "o_proj")
                        for w in ("weight", "bias")}
            partial |= {f"{prefix}.{n}.weight" for n in ("q_norm", "k_norm")
                        if hasattr(mod, n)}
        elif isinstance(mod, MLP) and not mod.gelu and is_split(
                prefix, "gate_proj", "up_proj", "down_proj"):
            mod.tp_group = group
            claimed |= {f"{prefix}.{n}.weight" for n in ("gate_proj",
                                                         "up_proj",
                                                         "down_proj")}
        elif isinstance(mod, DecoderModel) and \
                f"{prefix}.embed_tokens" in split:
            mod.vocab_group = group
            claimed.add(f"{prefix}.embed_tokens")
        elif isinstance(mod, CausalLM) and f"{prefix}.lm_head.weight" in split:
            mod.head_group = group
            claimed.add(f"{prefix}.lm_head.weight")
    unclaimed = split - claimed
    if unclaimed:
        raise ValueError(f"no tensor-parallel module computes with "
                         f"{sorted(unclaimed)}")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name in sorted(split):
            p, dim = params[name], places[name].tensor_dim
            size = p.shape[dim] // t
            p.data = p.data.narrow(dim, rank * size, size).clone()
    return partial


class ShardedParams:
    """A model's parameters placed on a mesh. After ``shard_decoder`` every
    parameter is tensor-local; they are kept in model order in two flat
    fp32 buffers, each an ``nn.Parameter`` that AdamW updates:

      * ``"sharded"``: the parameters of ``Placement.fsdp``, flattened,
        zero-padded to a multiple of the fsdp size, this rank's contiguous
        1/fsdp of it. Between steps the modules hold nothing of them;
        ``gather`` all-gathers the buffer over the fsdp group and points
        each parameter at its view of it, ``release`` frees it again;
      * ``"replicated"``: the rest, whole on every rank of the data and fsdp
        dims; the module's parameters are views of it, so AdamW's update of
        the buffer is the module's.

    With fsdp 1 the sharded buffer is whole and kept like the replicated
    one. ``reduce_grads`` turns the step's parameter gradients into the
    buffers' (the fsdp sum reduce-scattered, then summed over data; the
    replicated ones summed over data x fsdp, and first over the tensor
    group those of ``tensor_partial``); ``full`` and ``load_full``
    move whole (unsplit) tensors in and out, for checkpoints."""

    KINDS = ("sharded", "replicated")

    def __init__(self, model: nn.Module, mesh: Mesh,
                 places: Dict[str, Placement], tensor_partial=()):
        self.mesh = mesh
        self.places = places
        self.tensor_partial = set(tensor_partial)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        for name, p in named:
            if p.dtype != torch.float32:
                raise ValueError(f"{name}: a mesh trains fp32 parameters, "
                                 f"got {p.dtype}")
        self.fsdp = mesh.cfg.fsdp
        self.gathered = self.fsdp == 1
        self.layout: Dict[str, list] = {k: [] for k in self.KINDS}
        sizes = {k: 0 for k in self.KINDS}
        for name, p in named:
            kind = "sharded" if places[name].fsdp else "replicated"
            self.layout[kind].append((name, p, sizes[kind], p.numel(),
                                      tuple(p.shape)))
            sizes[kind] += p.numel()
        self.numel = sizes
        pad = -sizes["sharded"] % self.fsdp
        self.padded = {"sharded": sizes["sharded"] + pad,
                       "replicated": sizes["replicated"]}
        with torch.no_grad():
            flats = {k: self._flatten(k, {n: p for n, p, *_ in
                                          self.layout[k]}) for k in self.KINDS}
        self.buffers = {k: nn.Parameter(self._own(k, flats[k]))
                        for k in self.KINDS}
        # each parameter's [start, end) in this rank's part of each
        # buffer, and whether it is tensor-split (each rank holds distinct
        # elements of it)
        self.ranges = {k: self._local_ranges(k) for k in self.KINDS}
        self._point("replicated", self.buffers["replicated"])
        if self.gathered:
            self._point("sharded", self.buffers["sharded"])
        else:
            self.release()

    # -- layout --------------------------------------------------------------

    def _flatten(self, kind: str, tensors: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
        """The kind's tensors (tensor-local shapes; None for zeros) as one
        padded flat buffer."""
        dev = self.mesh.device
        parts = [torch.zeros(n, device=dev) if tensors[name] is None else
                 tensors[name].detach().reshape(-1).float().to(dev)
                 for name, _, _, n, _ in self.layout[kind]]
        parts.append(torch.zeros(self.padded[kind] - self.numel[kind],
                                 device=self.mesh.device))
        return torch.cat(parts)

    def _own(self, kind: str, flat: torch.Tensor) -> torch.Tensor:
        """This rank's part of a new whole flat buffer of ``kind``."""
        if kind == "replicated" or self.fsdp == 1:
            return flat
        n = flat.numel() // self.fsdp
        return flat[self.mesh.coords["fsdp"] * n:][:n].clone()

    def _local_ranges(self, kind: str) -> list:
        lo, hi = 0, self.padded[kind]
        if kind == "sharded" and self.fsdp > 1:
            n = hi // self.fsdp
            lo = self.mesh.coords["fsdp"] * n
            hi = lo + n
        out = []
        for name, _, at, n, _ in self.layout[kind]:
            a, b = max(at, lo), min(at + n, hi)
            if a < b:
                out.append((a - lo, b - lo,
                            self.places[name].tensor_dim is not None))
        return out

    def _whole(self, kind: str, local: torch.Tensor) -> torch.Tensor:
        """The whole flat buffer of ``kind`` from this rank's part of it
        (all-gathered over fsdp for the sharded kind)."""
        if kind == "sharded" and self.fsdp > 1:
            from .collectives import all_gather_flat

            return all_gather_flat(local, self.mesh.group("fsdp"))
        return local

    def _point(self, kind: str, whole: torch.Tensor) -> None:
        for _, p, at, n, shape in self.layout[kind]:
            p.data = whole[at:at + n].view(shape)

    # -- the step ------------------------------------------------------------

    def gather(self) -> None:
        """Point the fsdp-sharded parameters at a whole, gathered copy."""
        if not self.gathered:
            self._point("sharded", self._whole(
                "sharded", self.buffers["sharded"].detach()))
            self.gathered = True

    def release(self) -> None:
        """Free the gathered copy (fsdp > 1)."""
        if self.fsdp > 1:
            empty = torch.empty(0, device=self.mesh.device)
            for _, p, *_ in self.layout["sharded"]:
                p.data = empty
            self.gathered = False

    def reduce_grads(self, grads) -> Dict[str, torch.Tensor]:
        """One gradient per parameter in model order (None: zero) -> each
        buffer's gradient for this rank's part: summed over the ranks that
        hold other rows (data x fsdp)."""
        from .collectives import all_reduce_sum, reduce_scatter_flat

        by_name = dict(zip(self.names, grads))
        mesh = self.mesh
        for name in sorted(self.tensor_partial):  # one order on every rank
            if by_name[name] is not None:
                by_name[name] = all_reduce_sum(by_name[name],
                                               mesh.group("tensor"))
        out = {}
        for kind in self.KINDS:
            flat = self._flatten(kind, by_name)
            if kind == "sharded" and self.fsdp > 1:
                flat = reduce_scatter_flat(flat, mesh.group("fsdp"))
                if mesh.cfg.data > 1:
                    flat = all_reduce_sum(flat, mesh.group("data"))
            elif mesh.size("data,fsdp") > 1:
                flat = all_reduce_sum(flat, mesh.group("data,fsdp"))
            out[kind] = flat
        return out

    def square_norm_part(self, flat_grads: Dict[str, torch.Tensor]
                         ) -> torch.Tensor:
        """This rank's share of the squared global norm of the gradients:
        summed over every rank, each element counts once (held by one rank
        of the data dim, and of the tensor dim unless split over it, and of
        the fsdp dim unless sharded over it)."""
        c = self.mesh.coords
        total = torch.zeros((), device=self.mesh.device)
        if c["data"]:
            return total
        for kind, g in flat_grads.items():
            if kind == "replicated" and c["fsdp"]:
                continue
            for a, b, split in self.ranges[kind]:
                if split or not c["tensor"]:
                    total = total + torch.dot(g[a:b], g[a:b])
        return total

    # -- whole tensors, for checkpoints ------------------------------------

    def full(self, locals_: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole (unsplit) tensors by parameter name from this rank's part
        of each buffer-shaped tensor (the buffers, or AdamW's moments of
        them): views of them where nothing was gathered, as a one-card
        state dict holds the live tensors. Every rank of the mesh calls it;
        every rank gets them."""
        from .collectives import all_gather_dim

        out = {}
        tensor = self.mesh.group("tensor")
        for kind in self.KINDS:
            whole = self._whole(kind, locals_[kind].detach())
            for name, _, at, n, shape in self.layout[kind]:
                t = whole[at:at + n].view(shape)
                dim = self.places[name].tensor_dim
                if dim is not None:
                    t = all_gather_dim(t, dim, tensor)
                out[name] = t
        return {n: out[n] for n in self.names}

    def local(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of ``full``: this rank's part of each buffer from
        whole tensors by parameter name."""
        t, rank = self.mesh.cfg.tensor, self.mesh.coords["tensor"]
        tensors = {}
        for name in self.names:
            x = full[name]
            dim = self.places[name].tensor_dim
            if dim is not None:
                size = x.shape[dim] // t
                x = x.narrow(dim, rank * size, size)
            tensors[name] = x
        return {k: self._own(k, self._flatten(k, tensors)) for k in self.KINDS}

    @torch.no_grad()
    def load_full(self, full: Dict[str, torch.Tensor]) -> None:
        """Copy whole parameters (a one-card state dict's) into the
        buffers."""
        for kind, flat in self.local(full).items():
            self.buffers[kind].copy_(flat)
