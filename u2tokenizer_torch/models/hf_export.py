"""HF-layout checkpoints out (counterpart of
``u2tokenizer_tpu/models/hf_export.py``; the inverse of ``hf_weights``).

A parameter tree in the JAX package's layout (``weights.flax_params`` gives
one from a port model) exports to the state-dict names the reference's
u2Trainer writes and its remote-code packages load, and
``save_hf_checkpoint`` writes it as ``model.safetensors`` (fp32, through
the port's own writer) beside ``config.json`` and ``u2_tpu_config.json``,
the files the JAX package writes, so that each package reads the other's
checkpoints. The state dict is held on the host in fp32 while it is
written.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np

from ..config import U2ModelConfig
from .safetensors_io import write_safetensors


def _np(x) -> np.ndarray:
    # ascontiguousarray: transposed views must be materialized before
    # safetensors serializes the raw buffer
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _lin(sd: Dict[str, np.ndarray], name: str, p: Mapping):
    sd[name + ".weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    if "bias" in p:
        sd[name + ".bias"] = _np(p["bias"])


def _ln(sd: Dict[str, np.ndarray], name: str, p: Mapping):
    sd[name + ".weight"] = _np(p["scale"])
    sd[name + ".bias"] = _np(p["bias"])


def export_decoder(params: Mapping, cfg, sd: Dict[str, np.ndarray]) -> None:
    """CausalLM params {'model': ..., ['lm_head']} -> HF decoder names.

    Mirrors hf_weights.convert_decoder per family: phi3 re-fuses
    qkv_proj / gate_up_proj (the torch Phi3 modules only load fused
    names), phi2 uses layernorm scale+bias params, fc1/fc2 gelu MLP,
    self_attn.dense, model.final_layernorm, and no post-attention norm
    (parallel block) — so every family convert_decoder imports also
    round-trips back out.
    """
    model = params["model"]
    fused = cfg.model_type == "phi3"
    phi2 = cfg.model_type == "phi2"

    def norm(name: str, p: Mapping) -> None:
        if cfg.norm_type == "layernorm":
            sd[name + ".weight"] = _np(p["scale"])
            sd[name + ".bias"] = _np(p["bias"])
        else:
            sd[name + ".weight"] = _np(p["weight"])

    sd["model.embed_tokens.weight"] = _np(model["embed_tokens"])
    norm("model.final_layernorm" if phi2 else "model.norm", model["norm"])
    for i in range(cfg.num_layers):
        layer = model[f"layers_{i}"]
        p = f"model.layers.{i}."
        norm(p + "input_layernorm", layer["input_layernorm"])
        if not cfg.parallel_block:
            norm(p + "post_attention_layernorm",
                 layer["post_attention_layernorm"])
        attn = layer["self_attn"]
        if fused:
            sd[p + "self_attn.qkv_proj.weight"] = np.concatenate(
                [np.ascontiguousarray(_np(attn[nm]["kernel"]).T)
                 for nm in ("q_proj", "k_proj", "v_proj")], axis=0)
        else:
            for nm in ("q_proj", "k_proj", "v_proj"):
                _lin(sd, p + "self_attn." + nm, attn[nm])
        _lin(sd, p + ("self_attn.dense" if phi2 else "self_attn.o_proj"),
             attn["o_proj"])
        if cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = _np(attn["q_norm"]["weight"])
            sd[p + "self_attn.k_norm.weight"] = _np(attn["k_norm"]["weight"])
        mlp = layer["mlp"]
        if cfg.mlp_type == "gelu":
            _lin(sd, p + "mlp.fc1", mlp["fc1"])
            _lin(sd, p + "mlp.fc2", mlp["fc2"])
        elif fused:
            sd[p + "mlp.gate_up_proj.weight"] = np.concatenate(
                [np.ascontiguousarray(_np(mlp[nm]["kernel"]).T)
                 for nm in ("gate_proj", "up_proj")], axis=0)
            _lin(sd, p + "mlp.down_proj", mlp["down_proj"])
        else:
            for nm in ("gate_proj", "up_proj", "down_proj"):
                _lin(sd, p + "mlp." + nm, mlp[nm])
    if not cfg.tie_word_embeddings and "lm_head" in params:
        _lin(sd, "lm_head", params["lm_head"])


def export_vit(params: Mapping, cfg, sd: Dict[str, np.ndarray],
               prefix: str) -> None:
    _lin(sd, prefix + "patch_embedding.patch_embeddings.1",
         params["patch_embedding"]["proj"])
    sd[prefix + "patch_embedding.position_embeddings"] = _np(
        params["patch_embedding"]["position_embeddings"])
    if "cls_token" in params:
        sd[prefix + "cls_token"] = _np(params["cls_token"])
    _ln(sd, prefix + "norm", params["norm"])
    for i in range(cfg.num_layers):
        blk = params[f"blocks_{i}"]
        b = f"{prefix}blocks.{i}."
        _ln(sd, b + "norm1", blk["norm1"])
        _ln(sd, b + "norm2", blk["norm2"])
        sd[b + "attn.qkv.weight"] = np.ascontiguousarray(_np(blk["attn"]["qkv"]["kernel"]).T)
        if "bias" in blk["attn"]["qkv"]:
            sd[b + "attn.qkv.bias"] = _np(blk["attn"]["qkv"]["bias"])
        _lin(sd, b + "attn.out_proj", blk["attn"]["out_proj"])
        _lin(sd, b + "mlp.linear1", blk["mlp_fc1"])
        _lin(sd, b + "mlp.linear2", blk["mlp_fc2"])


def _export_attn(sd, prefix, p):
    for nm in ("wq", "wk", "wv", "dense"):
        if nm in p:
            _lin(sd, prefix + nm, p[nm])
    if "relative_bias" in p:
        sd[prefix + "relative_bias"] = _np(p["relative_bias"])


def export_u2tokenizer(params: Mapping, cfg: U2ModelConfig,
                       sd: Dict[str, np.ndarray]) -> None:
    u2t = cfg.u2t
    pre = "model.u2tokenizer."
    sd[pre + "query_tokens"] = _np(params["query_tokens"])
    svt = params["svt_module"]
    for i in range(u2t.num_layers):
        p = f"{pre}svt_module.attention_network.layers.{i}."
        _export_attn(sd, p + "spatial_attention.", svt[f"layers_{i}"]["spatial_attention"])
        _export_attn(sd, p + "temporal_attention.", svt[f"layers_{i}"]["temporal_attention"])
    _lin(sd, pre + "svt_module.token_selection.score_net",
         svt["token_selection"]["score_net"])
    if "dynamic_pool" in svt:
        sd[pre + "svt_module.dynamic_pool.gate_fc.weight"] = np.ascontiguousarray(
            _np(svt["dynamic_pool"]["gate_kernel"]).T)
        sd[pre + "svt_module.dynamic_pool.gate_fc.bias"] = _np(
            svt["dynamic_pool"]["gate_bias"])
    tta = params["tta_module"]
    for i in range(u2t.num_layers):
        p = f"{pre}tta_module.layers_vt.{i}."
        layer = tta[f"layers_vt_{i}"]
        _export_attn(sd, p + "self_attention.", layer["self_attention"])
        _export_attn(sd, p + "visual_cross_attention.", layer["visual_cross_attention"])
        _export_attn(sd, p + "text_cross_attention.", layer["text_cross_attention"])
        _ln(sd, p + "norm_self", layer["norm_self"])
        _ln(sd, p + "norm_cross_v", layer["norm_cross_v"])
        _ln(sd, p + "norm_cross_t", layer["norm_cross_t"])
    _export_attn(sd, pre + "tta_module.layer_linagg.linear_aggregator.",
                 tta["layer_linagg"]["linear_aggregator"])


def export_u2_state_dict(params: Mapping,
                         cfg: U2ModelConfig) -> Dict[str, np.ndarray]:
    """Full U2CausalLM params -> flat HF-layout state dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    export_decoder(p["llm"], cfg.llm, sd)
    if "vision_tower" in p:
        export_vit(p["vision_tower"]["vision_tower"], cfg.vision, sd,
                   "model.vision_tower.vision_tower.")
    if "mm_projector" in p:
        proj = p["mm_projector"]
        if cfg.projector.projector_type == "spp":
            torch_idx = 0
            for i in range(cfg.projector.layer_num):
                _lin(sd, f"model.mm_projector.projector.{torch_idx}",
                     proj[f"projector_{i}"])
                torch_idx += 2 if cfg.projector.layer_type == "mlp" else 1
        elif cfg.projector.projector_type == "linear":
            _lin(sd, "model.mm_projector.linear", proj["linear"])
    if "u2tokenizer" in p:
        export_u2tokenizer(p["u2tokenizer"], cfg, sd)
    if "seg_module" in p or "seg_projector" in p:
        # no torch-layout mapping exists for the JAX SegVol stack (the
        # emitted remote-code module is text+vision only); dropping the
        # params silently would let a '[SEG]' checkpoint reload with a
        # random seg head — make the loss loud. Native round-trips keep
        # seg weights via cli convert-checkpoint's msgpack tree.
        import warnings
        warnings.warn(
            "export_u2_state_dict: segmentation params (seg_module/"
            "seg_projector) are NOT exported to the HF state dict — use "
            "the native msgpack checkpoint to preserve the seg head")
    return sd


def save_hf_checkpoint(path: str, params: Mapping, cfg: U2ModelConfig,
                       extra_config: Optional[dict] = None) -> None:
    """Write model.safetensors + config.json (+ u2_tpu_config.json) in the
    u2 checkpoint layout."""
    os.makedirs(path, exist_ok=True)
    sd = export_u2_state_dict(params, cfg)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)

    config = {
        "model_type": f"u2{cfg.llm.model_type.capitalize()}",
        "architectures": [f"u2{cfg.llm.model_type.capitalize()}ForCausalLM"],
        "vocab_size": cfg.llm.vocab_size,
        "hidden_size": cfg.llm.hidden_size,
        "intermediate_size": cfg.llm.intermediate_size,
        "num_hidden_layers": cfg.llm.num_layers,
        "num_attention_heads": cfg.llm.num_heads,
        "num_key_value_heads": cfg.llm.num_kv_heads,
        "head_dim": cfg.llm.head_dim,
        "rope_theta": cfg.llm.rope_theta,
        "rms_norm_eps": cfg.llm.rms_norm_eps,
        # rope_scaling must survive config.json (Llama-3.2 checkpoints):
        # a consumer reading only config.json would otherwise compute
        # unscaled rotary frequencies and diverge from this model
        **({"rope_scaling": {
            "rope_type": cfg.llm.rope_scaling_type,
            "factor": cfg.llm.rope_scaling_factor,
            "low_freq_factor": cfg.llm.rope_low_freq_factor,
            "high_freq_factor": cfg.llm.rope_high_freq_factor,
            "original_max_position_embeddings":
                cfg.llm.rope_original_max_position,
        }} if cfg.llm.rope_scaling_type else {}),
        "tie_word_embeddings": cfg.llm.tie_word_embeddings,
        "max_position_embeddings": cfg.llm.max_position_embeddings,
        # u2 attributes (u2_arch.py:29-53)
        "image_channel": cfg.vision.in_channels,
        "image_size": list(cfg.vision.image_size),
        "patch_size": list(cfg.vision.patch_size),
        "vision_tower": "vit3d",
        "vision_select_layer": cfg.vision.select_layer,
        "vision_select_feature": cfg.vision.select_feature,
        "mm_projector_type": cfg.projector.projector_type,
        "proj_layer_type": cfg.projector.layer_type,
        "proj_layer_num": cfg.projector.layer_num,
        "proj_pooling_type": cfg.projector.pooling_type,
        "proj_pooling_size": cfg.projector.pooling_size,
        "mm_hidden_size": cfg.vision.hidden_size,
        "enable_u2tokenizer": cfg.u2t.enable,
        "u2t_num_heads": cfg.u2t.num_heads,
        "u2t_num_layers": cfg.u2t.num_layers,
        "u2t_top_k": cfg.u2t.top_k,
        "use_multi_scale": cfg.u2t.use_multi_scale,
        "num_3d_query_token": cfg.u2t.num_query_tokens,
        "attn_type": cfg.u2t.attn_type,
        "enable_diffts": cfg.u2t.enable_diffts,
        "enable_dmtp": cfg.u2t.enable_dmtp,
    }
    if extra_config:
        config.update(extra_config)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    with open(os.path.join(path, "u2_tpu_config.json"), "w") as f:
        f.write(cfg.to_json())

