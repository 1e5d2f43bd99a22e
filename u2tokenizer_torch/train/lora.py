"""LoRA and QLoRA (counterpart of ``u2tokenizer_tpu/train/lora.py``).

The reference's stage 1 (src/train/train_stage1.py:217-227, 342-361) puts
peft LoRA adapters (r=16, alpha=32) on every decoder linear but the
embeddings and the head, and trains the vision tower, projector,
μ²tokenizer and embeddings fully. The JAX package keeps two forms, and so
does the port, on modules, every parameter named by its flax path
(``weights.flax_path``, "params/llm/model/layers_0/self_attn/q_proj/kernel"):

  * float LoRA: adapters kept apart from the model, {kernel path: {"a":
    (in, r), "b": (r, out)}} (``init_lora_params``); ``apply_lora`` and
    ``merge_lora`` give the effective tree kernel + (alpha/r) A @ B; the
    trainer ``make_lora_train_step`` runs the model on those effective
    weights (``torch.func.functional_call``), takes gradients for the
    adapters and the fully trained modules and hands every leaf, the
    others with zero gradients, to the optimizer; ``save_lora_dir`` writes
    the adapter directory (``adapter.msgpack``, ``adapter_config.json``)
    that ``U2InferenceModel(lora_path=)`` folds into the base at load;
  * QLoRA (``cli train --qlora``): the decoder's base quantized to int8 or
    int4 in place (``models.quantize``), fresh fp32 adapters on every
    attention and MLP projection inside ``QDense`` (``qlora_config``,
    ``init_qlora_from_quantized``), and only the adapters, the μ²tokenizer
    and the projector trainable (``qlora_partition``): the vision tower,
    the integer base, the embeddings and the head are frozen, so the
    backward runs through the decoder and the μ²tokenizer alone and
    gradients and optimizer state exist for the trainable leaves only
    (``make_qlora_train_step``). ``make_qlora_trainer`` is the CLI's
    ``_run_qlora_training`` set-up: adapters in fp32, the μ²tokenizer and
    projector in the compute dtype (bf16), ``QLoraOptimizer`` (AdamW with
    weight decay 0 on the adapters, the port's copy of optax's Adafactor on
    the rest) under the warmup-cosine schedule. Its state's checkpoint
    holds the trainable leaves and the optimizer state only: a resumed run
    re-derives the frozen base from ``--pretrained`` by the same
    deterministic quantization.

The JAX package draws adapters from ``jax.random``, the port from a
``torch.Generator``: the same distributions (A ~ N(0, 1/r), B = 0), other
numbers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from ..config import LLMConfig, U2ModelConfig
from ..models.llm.decoder import QDense
from ..models.quantize import dequantize_llm_weights, quantize_llm_weights
from ..weights import flax_path, torch_name
from . import optim
from .checkpoint import load_params_msgpack, save_params_msgpack
from .sft import Optimizer, global_norm, make_loss_fn, make_schedule

# reference exclusion list (train_stage1.py:221)
DEFAULT_EXCLUDE = ("vision_tower", "mm_projector", "embed_tokens", "lm_head",
                   "seg_projector", "seg_module", "u2tokenizer")
# modules that remain fully trainable alongside the adapters
# (train_stage1.py:355-359)
DEFAULT_FULL_TRAIN = ("vision_tower", "mm_projector", "embed_tokens",
                      "lm_head", "u2tokenizer")
ADAPTERS = ("/lora_a", "/lora_b")
# the adapter directory form (``save_lora_dir``, ``load_lora_dir``)
ADAPTER_FILE, ADAPTER_CONFIG = "adapter.msgpack", "adapter_config.json"


@dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 32
    dropout: float = 0.05  # reference sets it; eval-mode here (no dropout)

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def is_lora_target(path: str, exclude=DEFAULT_EXCLUDE) -> bool:
    """2D 'kernel' leaves inside the decoder, minus the exclusion list."""
    if not path.endswith("/kernel"):
        return False
    return not any(kw in path for kw in exclude)


def named_leaves(model: nn.Module) -> Dict[str, Tuple[str, nn.Parameter]]:
    """{flax path: (torch name, parameter)} of every parameter."""
    modules = dict(model.named_modules())
    return {flax_path(name, modules): (name, p)
            for name, p in model.named_parameters()}


@torch.no_grad()
def init_lora_params(model: nn.Module, cfg: LoraConfig,
                     generator: torch.Generator,
                     exclude=DEFAULT_EXCLUDE) -> Dict[str, Dict[str, Any]]:
    """A/B adapters for every target kernel of ``model``, by flax path:
    A (in, r) ~ N(0, 1/r), B (r, out) = 0, fp32 on the model's device, so
    the adapted model starts exactly at the base model."""
    lora = {}
    for path, (_, p) in named_leaves(model).items():
        if p.dim() == 2 and is_lora_target(path, exclude):
            d_out, d_in = p.shape  # torch's (out, in); the kernel is (in, out)
            a = torch.empty(d_in, cfg.r, device=p.device)
            a.normal_(0.0, cfg.r ** -0.5, generator=generator)
            lora[path] = {"a": a, "b": torch.zeros(cfg.r, d_out,
                                                   device=p.device)}
    return lora


def _map_tree(fn: Callable, tree, prefix: str = ""):
    return {k: (_map_tree(fn, v, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else fn(f"{prefix}/{k}" if prefix
                                               else k, v))
            for k, v in tree.items()}


def apply_lora(params, lora: Dict[str, Any], cfg: LoraConfig):
    """Materialize effective params of a nested tree ({"params": ...} of
    tensors or numpy arrays, kernels (in, out) as flax holds them): kernel
    + scale * A @ B in the kernel's dtype, a tensor."""

    def update(path, leaf):
        if path in lora:
            leaf = torch.as_tensor(leaf)
            ab = lora[path]["a"] @ lora[path]["b"]
            return leaf + (cfg.scale * ab).to(leaf.dtype)
        return leaf

    return _map_tree(update, params)


def merge_lora(params, lora: Dict[str, Any], cfg: LoraConfig):
    """Fold adapters into the base weights (for export / inference)."""
    return apply_lora(params, lora, cfg)


def save_lora_dir(path: str, lora: Dict[str, Any], cfg: LoraConfig) -> None:
    """The adapter directory that ``U2InferenceModel(lora_path=)`` folds in
    at load: ``adapter.msgpack``, the {kernel path: {"a", "b"}} adapters
    in flax's msgpack form, and ``adapter_config.json`` with r and alpha."""
    os.makedirs(path, exist_ok=True)
    save_params_msgpack(os.path.join(path, ADAPTER_FILE), lora)
    with open(os.path.join(path, ADAPTER_CONFIG), "w") as f:
        json.dump({"r": cfg.r, "alpha": cfg.alpha}, f)


def load_lora_dir(path: str) -> Tuple[Dict[str, Any], LoraConfig]:
    """(adapters as CPU tensors, LoraConfig) of an adapter directory, read
    as the JAX package's ``U2InferenceModel._merge_lora`` reads it: a
    missing file raises ``FileNotFoundError``."""
    lora = load_params_msgpack(os.path.join(path, ADAPTER_FILE))
    with open(os.path.join(path, ADAPTER_CONFIG)) as f:
        acfg = json.load(f)
    return lora, LoraConfig(r=acfg["r"], alpha=acfg["alpha"])


def count_params(tree) -> int:
    """Elements of a module's parameters or of a nested tree's leaves."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())


def qlora_config(cfg, rank: int = 16, alpha: float = 32.0,
                 mode: "bool | str" = "int8"):
    """U2ModelConfig / LLMConfig copy set up for QLoRA: decoder kernels
    stored weight-only quantized with fp32 low-rank adapters on every
    decoder linear (``QDense``'s LoRA branch). As in the JAX package,
    embed_tokens and lm_head stay frozen and quantized."""
    llm = cfg.llm if hasattr(cfg, "llm") else cfg
    llm = dataclasses.replace(llm, quantized_weights=mode, lora_rank=rank,
                              lora_alpha=alpha)
    if hasattr(cfg, "llm"):
        return dataclasses.replace(cfg, llm=llm)
    return llm


def qlora_trainable_path(path: str,
                         full_train=("u2tokenizer", "mm_projector")) -> bool:
    """Trainable leaves under QLoRA: the fp32 adapters plus the full-rank
    multimodal modules (μ²tokenizer + projector, train_stage1.py:355-359).
    Vision tower frozen; decoder base integer; embeddings frozen."""
    if path.endswith(ADAPTERS):
        return True
    return any(kw in path for kw in full_train)


@torch.no_grad()
def qlora_partition(model: nn.Module
                    ) -> Tuple[Dict[str, nn.Parameter],
                               Dict[str, nn.Parameter]]:
    """Split a (quantized, LoRA-enabled) model's parameters into flat
    {flax path: parameter} dicts, (trainable, frozen), in place: the
    trainable ones cast to fp32 and requiring gradients, the frozen ones
    not. ``qlora_merge_trees`` gives the nested tree back."""
    train, frozen = {}, {}
    for path, (_, p) in named_leaves(model).items():
        if qlora_trainable_path(path) and p.is_floating_point():
            p.data = p.data.float()
            p.requires_grad_(True)
            train[path] = p
        else:
            p.requires_grad_(False)
            frozen[path] = p
    return train, frozen


def unflatten(flat: Dict[str, Any]) -> dict:
    """{"a/b/c": leaf} -> the nested tree (flax's ``unflatten_dict``)."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, key = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[key] = leaf
    return tree


@torch.no_grad()
def flax_tree(model: nn.Module, leaves: Dict[str, torch.Tensor]) -> dict:
    """{flax path: parameter} of ``model`` as the JAX package's nested
    tree, on the CPU in each leaf's own dtype (bf16 stays bf16), Dense
    kernels (in, out) as flax holds them: what ``cli train --qlora``
    writes to ``qlora_adapters.msgpack``."""
    modules = dict(model.named_modules())
    flat = {}
    for path, p in leaves.items():
        _, transpose = torch_name(path[len("params/"):], modules)
        t = p.detach().cpu()
        flat[path] = (t.t() if transpose else t).contiguous()
    return unflatten(flat)


def qlora_merge_trees(train_flat: Dict[str, Any],
                      frozen_flat: Dict[str, Any]) -> dict:
    merged = dict(frozen_flat)
    merged.update(train_flat)
    return unflatten(merged)


def _set_configs(model: nn.Module, cfg) -> None:
    """Every LLMConfig / U2ModelConfig a module holds replaced by ``cfg``'s
    (its ``llm`` for a decoder's)."""
    llm = cfg.llm if hasattr(cfg, "llm") else cfg
    for module in model.modules():
        held = getattr(module, "cfg", None)
        if isinstance(held, U2ModelConfig):
            module.cfg = cfg
        elif isinstance(held, LLMConfig):
            module.cfg = llm


def _decoder_projections(model: nn.Module):
    """The decoder's attention and MLP ``QDense`` layers (not the head)."""
    lm = model.llm if hasattr(model, "llm") else model
    for layer in lm.model.layers:
        for module in layer.modules():
            if isinstance(module, QDense):
                yield module


@torch.no_grad()
def init_qlora_from_quantized(model: nn.Module, qcfg,
                              generator: torch.Generator) -> nn.Module:
    """A QLoRA model from ``model`` (its decoder quantized in place by
    ``quantize_llm_weights`` in ``qcfg``'s mode): fresh adapters of rank
    ``qcfg.llm.lora_rank`` on every decoder projection, lora_a drawn from
    ``generator`` layer by layer, lora_b zero; the model's configs become
    ``qcfg``. Every other leaf is the quantized model's. Returns it."""
    llm = qcfg.llm if hasattr(qcfg, "llm") else qcfg
    if not llm.lora_rank:
        raise ValueError("qcfg has no lora_rank (qlora_config sets it)")
    scale = llm.lora_alpha / max(llm.lora_rank, 1)
    for dense in _decoder_projections(model):
        if dense.mode is None:
            raise ValueError("init_qlora_from_quantized needs the decoder "
                             "quantized (models.quantize)")
        dense.add_lora(llm.lora_rank, scale, generator)
    _set_configs(model, qcfg)
    return model


def make_qlora_train_step(tx, loss_fn: Callable):
    """Train step over the QLoRA-trainable leaves, the quantized base left
    in the model: gradients and optimizer state exist only for the
    adapters and the multimodal modules.

    loss_fn(model, batch) -> (loss, aux); ``tx.update(grads)`` takes a
    gradient per trainable leaf by flax path and updates the leaves in
    place (``QLoraOptimizer``). Returns step(train, model, batch) ->
    (loss, aux, grad_norm), ``train`` the {flax path: parameter} dict of
    ``qlora_partition``."""

    def step(train, model, batch):
        for p in train.values():
            p.grad = None
        loss, aux = loss_fn(model, batch)
        grads = dict(zip(train, torch.autograd.grad(
            loss, list(train.values()), allow_unused=True,
            materialize_grads=True)))
        tx.update(grads)
        return loss, aux, global_norm(grads.values())

    return step


@torch.no_grad()
def merge_qlora(model: nn.Module) -> nn.Module:
    """Fold QLoRA adapters into dequantized fp32 weights in place: each
    decoder linear becomes dequant(kernel) + (alpha/r) * lora_a @ lora_b,
    adapters and quant scales dropped, the configs float without LoRA.
    Exact up to the base's quantization error."""
    dequantize_llm_weights(model)
    for dense in _decoder_projections(model):
        if dense.lora_rank:
            ab = dense.lora_a.float() @ dense.lora_b.float()
            dense.weight.data = (dense.weight.float()
                                 + dense.lora_scale * ab.t()).contiguous()
            del dense.lora_a, dense.lora_b
            dense.lora_rank = 0
    cfg = model.cfg
    llm = cfg.llm if hasattr(cfg, "llm") else cfg
    llm = dataclasses.replace(llm, quantized_weights=False, lora_rank=0)
    _set_configs(model, dataclasses.replace(cfg, llm=llm)
                 if hasattr(cfg, "llm") else llm)
    return model


# ------------------------------------------------------ float-LoRA trainer --

@dataclass
class LoraState:
    """The float-LoRA trainer's state: the base model and the adapters
    ({kernel path: {"a", "b"}})."""
    step: int
    model: nn.Module
    lora: Dict[str, Dict[str, torch.Tensor]]


def lora_leaves(model: nn.Module, lora: Dict[str, Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """The leaves the float-LoRA trainer updates, in its order: each
    adapter ("lora/<kernel path>/a") and every base parameter
    ("base/<flax path>")."""
    out = {f"lora/{path}/{k}": t for path, ab in lora.items()
           for k, t in ab.items()}
    out.update({f"base/{path}": p for path, (_, p) in
                named_leaves(model).items()})
    return out


class _Bound(nn.Module):
    def __init__(self, model, loss_fn):
        super().__init__()
        self.model, self.loss_fn = model, loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def make_lora_train_step(model: nn.Module, tx, cfg: LoraConfig,
                         loss_fn: Callable, full_train=DEFAULT_FULL_TRAIN):
    """Train step over (adapters, base) with the base frozen outside
    ``full_train``: the model runs on the effective weights kernel +
    scale * A @ B; gradients reach the adapters and the fully trained
    modules, every other base leaf takes a zero gradient (the JAX
    package's mask), and ``tx`` (``sft.Optimizer`` over ``lora_leaves``,
    in its order) updates every leaf.
    loss_fn(model, batch) -> (loss, metrics); step(state, batch) ->
    (state, metrics with grad_norm)."""
    leaves = named_leaves(model)
    bound = _Bound(model, loss_fn)

    def train_step(state: LoraState, batch):
        live = {path: p for path, (_, p) in leaves.items()
                if any(kw in path for kw in full_train)}
        for t in [*live.values(), *(t for ab in state.lora.values()
                                    for t in ab.values())]:
            t.requires_grad_(True)
        eff = {}
        for path, (name, p) in leaves.items():
            if path in state.lora:
                ab = state.lora[path]["a"] @ state.lora[path]["b"]
                eff[f"model.{name}"] = p + (cfg.scale * ab).t().to(p.dtype)
            else:
                eff[f"model.{name}"] = p
        loss, metrics = torch.func.functional_call(bound, eff, (batch,))
        wrt = {f"lora/{path}/{k}": t for path, ab in state.lora.items()
               for k, t in ab.items()}
        wrt.update({f"base/{path}": p for path, p in live.items()})
        got = dict(zip(wrt, torch.autograd.grad(
            loss, list(wrt.values()), allow_unused=True,
            materialize_grads=True)))
        params = lora_leaves(model, state.lora)
        grads = {k: got[k] if k in got else torch.zeros_like(p)
                 for k, p in params.items()}
        tx.update(list(grads.values()))
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads.values())
        state.step += 1
        return state, metrics

    return train_step


# ------------------------------------------------------- the QLoRA trainer --

def is_adapter(path: str) -> bool:
    return path.endswith(ADAPTERS)


class QLoraOptimizer:
    """The JAX CLI's routing (``optax.multi_transform``) over ``train``,
    the {flax path: parameter} dict of ``qlora_partition``: AdamW with
    weight decay 0 on the adapters (``torch.optim.AdamW``, through
    ``sft.Optimizer`` as the SFT trainer runs it) and the port's copy of
    ``optax.adafactor(min_dim_size_to_factor=128)`` (``optim.Adafactor``)
    on the other trainable leaves, in their own dtype, both under
    ``schedule``. ``update(grads)`` takes a gradient per leaf by flax path
    and updates the leaves in place."""

    def __init__(self, train: Dict[str, nn.Parameter],
                 schedule: Callable[[int], float]):
        self.adapters = [k for k in train if is_adapter(k)]
        self.full = {k: p for k, p in train.items() if not is_adapter(k)}
        self.adamw = Optimizer([train[k] for k in self.adapters], schedule,
                               weight_decay=0.0)
        self.adafactor = optim.Adafactor(schedule)
        self.adafactor_state = self.adafactor.init(self.full)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        self.adamw.update([grads[k] for k in self.adapters])
        updates, self.adafactor_state = self.adafactor.update(
            {k: grads[k] for k in self.full}, self.adafactor_state,
            self.full)
        optim.apply_updates(self.full, updates)

    def state_dict(self) -> dict:
        return {"adapters": list(self.adapters),
                "adamw": self.adamw.state_dict(),
                "adafactor": self.adafactor_state}

    def load_state_dict(self, saved: dict) -> None:
        if saved["adapters"] != self.adapters:
            raise KeyError("the checkpoint's adapters are not this model's")
        self.adamw.load_state_dict(saved["adamw"])
        device = next(iter(self.full.values())).device
        self.adafactor_state = optim.state_to(saved["adafactor"], device)


@dataclass
class QLoraState:
    """The QLoRA run's state: the model (the frozen base and the trainable
    leaves), the trainable leaves by flax path and their optimizer. Its
    ``state_dict`` (what a checkpoint holds) has the trainable leaves and
    the optimizer's state, no frozen leaf."""
    step: int
    model: nn.Module
    train: Dict[str, nn.Parameter]
    optimizer: QLoraOptimizer

    def state_dict(self) -> dict:
        return {"step": self.step,
                "train": {k: p.detach() for k, p in self.train.items()},
                "optimizer": self.optimizer.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        if set(saved["train"]) != set(self.train):
            raise KeyError("the checkpoint's trainable leaves are not this "
                           "model's")
        for k, p in self.train.items():
            p.copy_(saved["train"][k])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.step = saved["step"]


def make_qlora_trainer(model: nn.Module, tcfg, total_steps: int,
                       mode: str = "int8", rank: int = 16,
                       alpha: float = 32.0):
    """(QLoraState, train_step) for a float ``model`` (``U2CausalLM`` with
    its weights loaded, on its device), as the JAX CLI's
    ``_run_qlora_training`` sets up: the decoder quantized to ``mode`` in
    place, adapters of ``rank`` / ``alpha`` drawn from ``tcfg.seed`` + 1,
    the partition (adapters fp32; the μ²tokenizer and projector in the
    compute dtype, bf16 when ``tcfg.bf16``), ``QLoraOptimizer`` under
    ``sft.make_schedule``, the loss of ``sft.make_loss_fn``.
    train_step(state, batch) -> (state, {loss, token_accuracy,
    grad_norm})."""
    device = next(model.parameters()).device
    dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
    quantize_llm_weights(model, mode)
    generator = torch.Generator(device=device).manual_seed(tcfg.seed + 1)
    init_qlora_from_quantized(
        model, qlora_config(model.cfg, rank, alpha, mode), generator)
    train, _ = qlora_partition(model)
    with torch.no_grad():
        for path, p in train.items():
            if not is_adapter(path):
                p.data = p.data.to(dtype)
    # the JAX CLI's warmup_cosine_decay_schedule, whatever tcfg.lr_schedule
    tx = QLoraOptimizer(train, make_schedule(
        dataclasses.replace(tcfg, lr_schedule="cosine"), total_steps))
    step = make_qlora_train_step(tx, make_loss_fn(tcfg.ce_chunk))
    state = QLoraState(step=0, model=model, train=train, optimizer=tx)

    def train_step(state: QLoraState, batch):
        _, aux, norm = step(state.train, state.model, batch)
        state.step += 1
        return state, {**aux, "grad_norm": norm}

    return state, train_step
