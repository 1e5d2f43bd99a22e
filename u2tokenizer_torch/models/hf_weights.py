"""HF-layout checkpoints in (counterpart of
``u2tokenizer_tpu/models/hf_weights.py``): state dicts from .safetensors or
``pytorch_model.bin`` files, converted to the JAX package's parameter tree.

The converters return the same nested tree of fp32 numpy arrays as the JAX
package's, key for key, so that the two can be compared; the tree goes into
the port's modules through ``weights.flatten`` and
``weights.load_flax_params``. Orientation: HF ``nn.Linear`` weights are
(out, in) and flax ``Dense`` kernels (in, out), so every linear transposes;
embedding tables keep (vocab, hidden); Phi-3's fused qkv_proj and
gate_up_proj are split.

Both loaders return CPU torch tensors mapped from the files
(``safetensors_io.read_safetensors``, ``torch.load(mmap=True)``), and an fp32
leaf stays a view of its file through the conversion, so that loading a
checkpoint into a model holds one leaf at a time on the host
(``load_flax_params`` copies leaf by leaf); fp16 and bf16 leaves become
fp32 copies.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from ..config import (LLMConfig, ProjectorConfig, U2ModelConfig,
                      U2TokenizerConfig, VisionConfig)
from .safetensors_io import read_safetensors


def _np(x) -> np.ndarray:
    """A state-dict value as an fp32 numpy array (a view where it is one)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x)


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of the *.safetensors shards of a checkpoint directory
    (those ``model.safetensors.index.json`` names, where it exists)."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = [f for f in sorted(os.listdir(path))
                 if f.endswith(".safetensors")]
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname)))
    return tensors


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A torch-serialized state dict (``pytorch_model.bin``), mapped."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


# ---------------------------------------------------------------------------
# decoder conversion
# ---------------------------------------------------------------------------

def convert_decoder(sd: Mapping[str, np.ndarray], cfg: LLMConfig,
                    prefix: str = "") -> dict:
    """HF decoder state dict -> params for our CausalLM module.

    Args:
      sd: flat name->array mapping with HF names (model.layers.0....).
      prefix: key prefix inside sd (e.g. 'model.' already included; pass a
        prefix like 'policy.' if the dict nests the model).
    """
    g = lambda name: np.asarray(sd[prefix + name], dtype=np.float32)
    has = lambda name: (prefix + name) in sd

    def lin(name, bias=False):
        p = {"kernel": g(name + ".weight").T}
        if bias and has(name + ".bias"):
            p["bias"] = g(name + ".bias")
        return p

    def norm(name):
        p = {"weight" if cfg.norm_type == "rmsnorm" else "scale":
             g(name + ".weight")}
        if cfg.norm_type == "layernorm":
            p["bias"] = g(name + ".bias")
        return p

    final_norm = ("model.final_layernorm"
                  if has("model.final_layernorm.weight") else "model.norm")
    model: dict = {
        "embed_tokens": g("model.embed_tokens.weight"),
        "norm": norm(final_norm),
    }
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layer: dict = {"input_layernorm": norm(p + "input_layernorm")}
        if not cfg.parallel_block:
            layer["post_attention_layernorm"] = norm(
                p + "post_attention_layernorm")
        attn: dict = {}
        if has(p + "self_attn.qkv_proj.weight"):  # Phi-3 fused qkv
            w = g(p + "self_attn.qkv_proj.weight")
            qn, kn = nh * hd, nkv * hd
            attn["q_proj"] = {"kernel": w[:qn].T}
            attn["k_proj"] = {"kernel": w[qn:qn + kn].T}
            attn["v_proj"] = {"kernel": w[qn + kn:].T}
        else:
            attn["q_proj"] = lin(p + "self_attn.q_proj", cfg.attention_bias)
            attn["k_proj"] = lin(p + "self_attn.k_proj", cfg.attention_bias)
            attn["v_proj"] = lin(p + "self_attn.v_proj", cfg.attention_bias)
        o_name = (p + "self_attn.dense" if has(p + "self_attn.dense.weight")
                  else p + "self_attn.o_proj")
        attn["o_proj"] = lin(o_name, cfg.attention_bias)
        if cfg.qk_norm:
            attn["q_norm"] = {"weight": g(p + "self_attn.q_norm.weight")}
            attn["k_norm"] = {"weight": g(p + "self_attn.k_norm.weight")}
        layer["self_attn"] = attn

        if cfg.mlp_type == "gelu":  # Phi-2 fc1/fc2
            layer["mlp"] = {
                "fc1": lin(p + "mlp.fc1", cfg.mlp_bias),
                "fc2": lin(p + "mlp.fc2", cfg.mlp_bias),
            }
        elif has(p + "mlp.gate_up_proj.weight"):  # Phi-3 fused gate/up
            w = g(p + "mlp.gate_up_proj.weight")
            half = w.shape[0] // 2
            layer["mlp"] = {
                "gate_proj": {"kernel": w[:half].T},
                "up_proj": {"kernel": w[half:].T},
                "down_proj": lin(p + "mlp.down_proj"),
            }
        else:
            layer["mlp"] = {
                "gate_proj": lin(p + "mlp.gate_proj"),
                "up_proj": lin(p + "mlp.up_proj"),
                "down_proj": lin(p + "mlp.down_proj"),
            }
        model[f"layers_{i}"] = layer

    out: dict = {"model": model}
    if not cfg.tie_word_embeddings:
        if has("lm_head.weight"):
            out["lm_head"] = lin("lm_head", cfg.lm_head_bias)
        else:  # some checkpoints tie silently
            out["lm_head"] = {"kernel": g("model.embed_tokens.weight").T}
    return out


# ---------------------------------------------------------------------------
# vision / projector / u2tokenizer conversion (trained u2 checkpoints)
# ---------------------------------------------------------------------------

def _linear(sd, name):
    p = {"kernel": np.asarray(sd[name + ".weight"], np.float32).T}
    if name + ".bias" in sd:
        p["bias"] = np.asarray(sd[name + ".bias"], np.float32)
    return p


def _layernorm(sd, name):
    return {"scale": np.asarray(sd[name + ".weight"], np.float32),
            "bias": np.asarray(sd[name + ".bias"], np.float32)}


def convert_vit(sd: Mapping[str, np.ndarray], cfg, prefix: str) -> dict:
    """MONAI ViT state dict -> our ViT3D params.

    Expected keys (e.g. prefix='model.vision_tower.vision_tower.'):
    patch_embedding.patch_embeddings.1.{weight,bias} (perceptron Linear),
    patch_embedding.position_embeddings, cls_token,
    blocks.{i}.{norm1,attn.qkv,attn.out_proj,norm2,mlp.linear1,mlp.linear2},
    norm.{weight,bias}.
    """
    g = lambda n: np.asarray(sd[prefix + n], np.float32)
    sub = lambda n: _linear(sd, prefix + n)
    ln = lambda n: _layernorm(sd, prefix + n)

    params: dict = {
        "patch_embedding": {
            "proj": sub("patch_embedding.patch_embeddings.1"),
            "position_embeddings": g("patch_embedding.position_embeddings"),
        },
        "norm": ln("norm"),
    }
    if prefix + "cls_token" in sd:
        params["cls_token"] = g("cls_token")
    for i in range(cfg.num_layers):
        b = f"blocks.{i}."
        blk = {
            "norm1": ln(b + "norm1"),
            "norm2": ln(b + "norm2"),
            "attn": {
                "qkv": {"kernel": g(b + "attn.qkv.weight").T},
                "out_proj": sub(b + "attn.out_proj"),
            },
            "mlp_fc1": sub(b + "mlp.linear1"),
            "mlp_fc2": sub(b + "mlp.linear2"),
        }
        if prefix + b + "attn.qkv.bias" in sd:
            blk["attn"]["qkv"]["bias"] = g(b + "attn.qkv.bias")
        params[f"blocks_{i}"] = blk
    return params


def convert_u2_checkpoint(sd: Mapping[str, np.ndarray],
                          cfg: U2ModelConfig) -> dict:
    """Full trained μ² checkpoint (HF-layout state dict with model.vision_tower,
    model.mm_projector, model.u2tokenizer, model.layers, lm_head) -> U2CausalLM
    params."""
    sd = {k: _np(v) for k, v in sd.items()}
    params: dict = {}

    # decoder
    params["llm"] = convert_decoder(sd, cfg.llm)

    # vision tower
    params["vision_tower"] = {
        "vision_tower": convert_vit(sd, cfg.vision,
                                    "model.vision_tower.vision_tower.")
    }

    # projector (spp mlp: projector.0 / projector.2 with GELU between)
    if cfg.projector.projector_type == "spp":
        proj = {}
        torch_idx = 0
        for i in range(cfg.projector.layer_num):
            proj[f"projector_{i}"] = _linear(
                sd, f"model.mm_projector.projector.{torch_idx}")
            torch_idx += 2 if cfg.projector.layer_type == "mlp" else 1
        params["mm_projector"] = proj
    elif cfg.projector.projector_type == "linear":
        params["mm_projector"] = {"linear": _linear(sd, "model.mm_projector.linear")}

    # u2tokenizer
    if cfg.u2t.enable and any(k.startswith("model.u2tokenizer.") for k in sd):
        params["u2tokenizer"] = _convert_u2tok(
            {k[len("model.u2tokenizer."):]: v for k, v in sd.items()
             if k.startswith("model.u2tokenizer.")}, cfg)
    return {"params": params}


def _attn_params(sd, prefix, compress_used=False):
    if prefix + "in_proj_weight" in sd:
        # torch nn.MultiheadAttention layout — the trained-checkpoint flavor
        # with enable_rpe=False (base_model_tokenizers/.../u2Tokenizer.py:92):
        # fused (3E, E) in_proj splits into our wq/wk/wv.
        w = np.asarray(sd[prefix + "in_proj_weight"], np.float32)
        e = w.shape[0] // 3
        p = {"wq": {"kernel": w[:e].T}, "wk": {"kernel": w[e:2 * e].T}}
        if not compress_used:
            p["wv"] = {"kernel": w[2 * e:].T}
            p["dense"] = _linear(sd, prefix + "out_proj")
        if prefix + "in_proj_bias" in sd:
            b = np.asarray(sd[prefix + "in_proj_bias"], np.float32)
            p["wq"]["bias"] = b[:e]
            p["wk"]["bias"] = b[e:2 * e]
            if not compress_used:
                p["wv"]["bias"] = b[2 * e:]
        return p
    p = {"wq": _linear(sd, prefix + "wq"), "wk": _linear(sd, prefix + "wk")}
    if not compress_used:
        if prefix + "wv.weight" in sd:
            p["wv"] = _linear(sd, prefix + "wv")
        if prefix + "dense.weight" in sd:
            p["dense"] = _linear(sd, prefix + "dense")
    if prefix + "relative_bias" in sd:
        p["relative_bias"] = np.asarray(sd[prefix + "relative_bias"], np.float32)
    return p


def _convert_u2tok(sd: Mapping[str, np.ndarray], cfg: U2ModelConfig) -> dict:
    u2t = cfg.u2t
    params: dict = {"query_tokens": np.asarray(sd["query_tokens"], np.float32)}
    svt: dict = {}
    for i in range(u2t.num_layers):
        p = f"svt_module.attention_network.layers.{i}."
        svt[f"layers_{i}"] = {
            "spatial_attention": _attn_params(sd, p + "spatial_attention."),
            "temporal_attention": _attn_params(sd, p + "temporal_attention."),
        }
    svt["token_selection"] = {
        "score_net": _linear(sd, "svt_module.token_selection.score_net")}
    if u2t.enable_dmtp and "svt_module.dynamic_pool.gate_fc.weight" in sd:
        svt["dynamic_pool"] = {
            "gate_kernel": np.asarray(
                sd["svt_module.dynamic_pool.gate_fc.weight"], np.float32).T,
            "gate_bias": np.asarray(
                sd["svt_module.dynamic_pool.gate_fc.bias"], np.float32),
        }
    params["svt_module"] = svt

    tta: dict = {}
    for i in range(u2t.num_layers):
        p = f"tta_module.layers_vt.{i}."
        tta[f"layers_vt_{i}"] = {
            "self_attention": _attn_params(sd, p + "self_attention."),
            "visual_cross_attention": _attn_params(sd, p + "visual_cross_attention."),
            "text_cross_attention": _attn_params(sd, p + "text_cross_attention."),
            "norm_self": _layernorm(sd, p + "norm_self"),
            "norm_cross_v": _layernorm(sd, p + "norm_cross_v"),
            "norm_cross_t": _layernorm(sd, p + "norm_cross_t"),
        }
    tta["layer_linagg"] = {"linear_aggregator": _attn_params(
        sd, "tta_module.layer_linagg.linear_aggregator.", compress_used=True)}
    params["tta_module"] = tta
    return params


def u2_config_from_hf(hf_config, num_chunks: int = 8) -> U2ModelConfig:
    """Build a full U2ModelConfig from a trained μ² checkpoint config.

    Covers the released remote-code checkpoints
    (base_model_tokenizers/Llama-3.2-1B-Instruct/config.json): u2 attributes
    (enable_u2tokenizer/u2t_*/enable_rpe/enable_diffts/enable_dmtp), projector
    attributes (mm_projector_type/proj_*), vision geometry (image_size
    declared depth-first in that flavor), and the decoder config including
    llama3 rope_scaling. A checkpoint's config.json + state dict load
    unchanged through (u2_config_from_hf, convert_u2_checkpoint).
    """
    get: Callable = (hf_config.get if isinstance(hf_config, dict)
                     else lambda k, d=None: getattr(hf_config, k, d))
    image_size = tuple(get("image_size") or (256, 256, 32))
    patch_size = tuple(get("patch_size") or (4, 16, 16))
    # trained checkpoints declare (D, H, W); src flavor declares (H, W, D)
    depth_axis = 0 if image_size[0] <= min(image_size) else 2
    vision = VisionConfig(
        in_channels=int(get("image_channel", 1)),
        image_size=image_size,
        patch_size=patch_size,
        hidden_size=int(get("mm_hidden_size", 768)),
        # the reference hardcodes the MONAI ViT dims (12L/3072/12h); our own
        # emitted configs carry them explicitly (models/remote_code.py)
        num_layers=int(get("vision_num_layers", 12) or 12),
        mlp_dim=int(get("vision_mlp_dim", 3072) or 3072),
        num_heads=int(get("vision_num_heads", 12) or 12),
        qkv_bias=bool(get("vision_qkv_bias", False)),
        select_layer=int(get("vision_select_layer", -1)),
        select_feature=get("vision_select_feature", "patch"),
        depth_axis=depth_axis,
    )
    projector = ProjectorConfig(
        projector_type=get("mm_projector_type", "spp"),
        layer_type=get("proj_layer_type", "mlp"),
        layer_num=int(get("proj_layer_num", 2)),
        pooling_type=get("proj_pooling_type", "spatial"),
        pooling_size=int(get("proj_pooling_size", 2)),
    )
    if get("attn_type") is not None:  # src flavor
        attn_type = get("attn_type")
    else:  # checkpoint flavor: enable_rpe bool (u2Tokenizer.py:397)
        attn_type = "rma" if get("enable_rpe", False) else "vanilla"
    u2t = U2TokenizerConfig(
        enable=bool(get("enable_u2tokenizer", True)),
        num_heads=int(get("u2t_num_heads", 8)),
        num_layers=int(get("u2t_num_layers", 4)),
        top_k=int(get("u2t_top_k", 1024)),
        use_multi_scale=bool(get("use_multi_scale", True)),
        num_query_tokens=int(get("num_3d_query_token", 256)),
        attn_type=attn_type,
        enable_diffts=bool(get("enable_diffts", False)),
        enable_dmtp=bool(get("enable_dmtp", False)),
        max_seq_len=int(get("u2t_max_seq_len", 512) or 512),
    )
    return U2ModelConfig(vision=vision, projector=projector, u2t=u2t,
                         llm=llm_config_from_hf(hf_config),
                         num_chunks=num_chunks)


def llm_config_from_hf(hf_config) -> LLMConfig:
    """Build our LLMConfig from a transformers config object or dict."""
    get: Callable = (hf_config.get if isinstance(hf_config, dict)
                     else lambda k, d=None: getattr(hf_config, k, d))
    mt = (get("model_type") or "qwen3").lower()
    family = ("qwen3" if "qwen3" in mt else
              "phi3" if "phi3" in mt else
              "phi2" if mt == "phi" or "phi-2" in mt or "phi2" in mt else
              "llama")
    nh = get("num_attention_heads")
    phi2 = family == "phi2"
    rs = get("rope_scaling") or {}
    rs_type = rs.get("rope_type") or rs.get("type") if rs else None
    return LLMConfig(
        rope_scaling_type=rs_type,
        rope_scaling_factor=float(rs.get("factor", 1.0)) if rs else 1.0,
        rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)) if rs else 1.0,
        rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)) if rs else 4.0,
        rope_original_max_position=int(rs.get(
            "original_max_position_embeddings", 8192)) if rs else 8192,
        model_type=family,
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=nh,
        num_kv_heads=get("num_key_value_heads") or nh,
        head_dim=get("head_dim") or get("hidden_size") // nh,
        rope_theta=get("rope_theta", 10_000.0),
        rms_norm_eps=get("rms_norm_eps") or get("layer_norm_eps", 1e-6),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        qk_norm=family == "qwen3",
        max_position_embeddings=get("max_position_embeddings", 4096),
        attention_bias=bool(get("attention_bias", phi2)),
        parallel_block=phi2,
        partial_rotary_factor=get("partial_rotary_factor", 1.0) if phi2 else 1.0,
        norm_type="layernorm" if phi2 else "rmsnorm",
        mlp_type="gelu" if phi2 else "swiglu",
        mlp_bias=phi2,
        lm_head_bias=phi2,
    )
