"""Typed configuration for the PyTorch port.

A copy of the configuration dataclasses of the JAX package (same class
names, field names, field order and defaults), so that a config written
for one package builds the same model in the other:
``U2ModelConfig.from_dict(dataclasses.asdict(other_cfg))``. A config with
no arguments describes the published μ²Qwen3-1.7B architecture.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


def _tuple(x) -> Tuple[int, ...]:
    return tuple(int(v) for v in x)


@dataclass(frozen=True)
class VisionConfig:
    """3D ViT vision tower. Input tensor (B, 1, 32, 256, 256); patch grid
    (32/4, 256/16, 256/16) = 2048 patches, which equals the declared product
    64*16*2 of ``image_size``/``patch_size``."""

    in_channels: int = 1
    image_size: Tuple[int, int, int] = (256, 256, 32)
    patch_size: Tuple[int, int, int] = (4, 16, 16)
    hidden_size: int = 768
    mlp_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    qkv_bias: bool = False
    classification: bool = True  # adds a cls token
    select_layer: int = -1  # -1 = final LN output
    select_feature: str = "patch"  # strip cls token
    use_flash_attention: bool = True  # hand-written attention kernel on GPU
    # Which declared image_size index is depth: 2 for the (H, W, D) source
    # ordering, 0 for the (D, H, W) ordering of trained checkpoints. It also
    # fixes the SPP grid arrangement (ProjectorConfig.grid_pre).
    depth_axis: int = 2

    @property
    def input_spatial(self) -> Tuple[int, int, int]:
        """Actual (D, H, W) of the per-chunk input tensor."""
        if self.depth_axis == 0:
            return tuple(self.image_size)
        return (self.image_size[2], self.image_size[0], self.image_size[1])

    @property
    def patch_grid(self) -> Tuple[int, int, int]:
        d, h, w = self.input_spatial
        pd, ph, pw = self.patch_size
        return (d // pd, h // ph, w // pw)

    @property
    def num_patches(self) -> int:
        g = self.patch_grid
        return g[0] * g[1] * g[2]


@dataclass(frozen=True)
class ProjectorConfig:
    """MM projector. 'spp' reshapes the 2048 patch tokens to the *declared*
    grid (64, 16, 2), average-pools with kernel/stride ``pooling_size`` to
    (32, 8, 1) = 256 tokens, then applies a linear/mlp stack."""

    projector_type: str = "spp"  # spp | linear | identity
    layer_type: str = "mlp"  # linear | mlp
    layer_num: int = 2
    pooling_type: str = "spatial"  # spatial | sequence
    pooling_size: int = 2

    def grid_pre(self, image_size, patch_size) -> Tuple[int, int, int]:
        # declared grid ordering, not the runtime geometry
        return tuple(i // p for i, p in zip(image_size, patch_size))

    def grid_post(self, image_size, patch_size) -> Tuple[int, int, int]:
        return tuple(g // self.pooling_size
                     for g in self.grid_pre(image_size, patch_size))

    def proj_out_num(self, image_size, patch_size) -> int:
        n = 1
        for g in self.grid_post(image_size, patch_size):
            n *= g
        return n


@dataclass(frozen=True)
class U2TokenizerConfig:
    """μ²Tokenizer: SVR refiner + TTA aggregator."""

    enable: bool = True
    num_heads: int = 8
    num_layers: int = 4
    top_k: int = 1024
    use_multi_scale: bool = True
    num_query_tokens: int = 256
    attn_type: str = "rma"  # rma | rope | vanilla
    enable_diffts: bool = False
    enable_dmtp: bool = False
    max_seq_len: int = 512  # relative-bias span
    scales: Tuple[int, ...] = (1, 2, 4)
    diffts_tau: float = 1.0


@dataclass(frozen=True)
class LLMConfig:
    """Decoder-only LM config (Qwen3 / Llama / Phi families)."""

    model_type: str = "qwen3"  # qwen3 | llama | phi3
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    # HF rope_scaling (type 'llama3'); None type = no scaling.
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    qk_norm: bool = True  # Qwen3 per-head q/k RMSNorm
    max_position_embeddings: int = 40960
    attention_bias: bool = False
    use_flash_attention: bool = True  # hand-written prefill kernel on GPU
    # Phi-2's switches (the GREEN-RadPhi2 judge's base)
    parallel_block: bool = False
    partial_rotary_factor: float = 1.0
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_type: str = "swiglu"  # swiglu | gelu
    mlp_bias: bool = False
    lm_head_bias: bool = False
    # Weight-only quantization (int8, int4) and lm_head tiling are served
    # (models/quantize.py); lora_rank > 0 gives each decoder projection
    # (QDense, float or quantized) its LoRA branch (train/lora.py).
    quantized_weights: "bool | str" = False
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lm_head_tiles: int = 0

    @classmethod
    def qwen3_1_7b(cls, vocab_size: int = 151936) -> "LLMConfig":
        return cls(vocab_size=vocab_size)

    @classmethod
    def qwen3_8b(cls, vocab_size: int = 151936) -> "LLMConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=4096, intermediate_size=12288,
            num_layers=36, num_heads=32, num_kv_heads=8,
            tie_word_embeddings=False,
        )

    @classmethod
    def llama_3_2_1b(cls, vocab_size: int = 128260) -> "LLMConfig":
        """μ²Llama-3.2-1B's decoder; its rope_scaling is the released
        checkpoint's (Llama-3.2-1B-Instruct config.json)."""
        return cls(
            model_type="llama", vocab_size=vocab_size, hidden_size=2048,
            intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
            head_dim=64, rope_theta=500_000.0, rms_norm_eps=1e-5,
            tie_word_embeddings=True, qk_norm=False,
            max_position_embeddings=131072,
            rope_scaling_type="llama3", rope_scaling_factor=32.0,
            rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
            rope_original_max_position=8192,
        )

    @classmethod
    def phi3_mini(cls, vocab_size: int = 32064) -> "LLMConfig":
        """μ²Phi-3-mini's decoder (Phi-3-mini-4k: MHA, 32 heads of 96)."""
        return cls(
            model_type="phi3", vocab_size=vocab_size, hidden_size=3072,
            intermediate_size=8192, num_layers=32, num_heads=32, num_kv_heads=32,
            head_dim=96, rope_theta=10_000.0, rms_norm_eps=1e-5,
            tie_word_embeddings=False, qk_norm=False,
            max_position_embeddings=4096,
        )

    @classmethod
    def phi2(cls, vocab_size: int = 51200) -> "LLMConfig":
        """Phi-2 (the GREEN-RadPhi2 judge's base): parallel blocks, partial
        rotary, LayerNorm, GELU MLP, biases everywhere."""
        return cls(
            model_type="phi2", vocab_size=vocab_size, hidden_size=2560,
            intermediate_size=10240, num_layers=32, num_heads=32,
            num_kv_heads=32, head_dim=80, rope_theta=10_000.0,
            rms_norm_eps=1e-5, tie_word_embeddings=False, qk_norm=False,
            max_position_embeddings=2048, attention_bias=True,
            parallel_block=True, partial_rotary_factor=0.4,
            norm_type="layernorm", mlp_type="gelu", mlp_bias=True,
            lm_head_bias=True,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LLMConfig":
        """A tiny config for tests."""
        return cls(
            vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            rope_theta=10_000.0, max_position_embeddings=2048,
        )


@dataclass(frozen=True)
class SegConfig:
    """Promptable 3D segmentation head (``models/seg.py``): the reference
    SegVol geometry, a 12 x 768 encoder over the whole (32, 256, 256)
    volume in (4, 16, 16) patches and a two-way decoder of depth 2 with 8
    heads."""

    enable: bool = False
    image_size: Tuple[int, int, int] = (32, 256, 256)
    patch_size: Tuple[int, int, int] = (4, 16, 16)
    encoder_dim: int = 768
    encoder_layers: int = 12
    encoder_heads: int = 12
    prompt_dim: int = 768
    decoder_layers: int = 2
    decoder_heads: int = 8

    @property
    def feat_shape(self) -> Tuple[int, int, int]:
        return tuple(i // p for i, p in zip(self.image_size, self.patch_size))

    @classmethod
    def tiny(cls) -> "SegConfig":
        return cls(enable=True, image_size=(16, 32, 32), patch_size=(4, 8, 8),
                   encoder_dim=32, encoder_layers=1, encoder_heads=2,
                   prompt_dim=32, decoder_layers=1, decoder_heads=2)


@dataclass(frozen=True)
class U2ModelConfig:
    """Full μ²LLM = vision tower + projector + μ²tokenizer + decoder."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    u2t: U2TokenizerConfig = field(default_factory=U2TokenizerConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    seg: SegConfig = field(default_factory=SegConfig)
    num_chunks: int = 8  # T: depth chunks per volume

    @property
    def proj_out_num(self) -> int:
        return self.projector.proj_out_num(self.vision.image_size,
                                           self.vision.patch_size)

    @classmethod
    def tiny(cls) -> "U2ModelConfig":
        """Small end-to-end config for tests: 2-chunk volumes, tiny LLM."""
        vision = VisionConfig(
            image_size=(32, 32, 16), patch_size=(4, 8, 8), hidden_size=64,
            mlp_dim=128, num_layers=2, num_heads=4,
        )
        u2t = U2TokenizerConfig(num_heads=4, num_layers=2, top_k=8,
                                num_query_tokens=8, max_seq_len=64)
        return cls(vision=vision, u2t=u2t, llm=LLMConfig.tiny(), num_chunks=2)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "U2ModelConfig":
        def build(c, sub):
            names = {f.name for f in dataclasses.fields(c)}
            kw = {k: (_tuple(v) if isinstance(v, (list, tuple)) else v)
                  for k, v in dict(sub).items() if k in names}
            return c(**kw)

        return cls(
            vision=build(VisionConfig, d.get("vision", {})),
            projector=build(ProjectorConfig, d.get("projector", {})),
            u2t=build(U2TokenizerConfig, d.get("u2t", {})),
            llm=build(LLMConfig, d.get("llm", {})),
            seg=build(SegConfig, d.get("seg", {})),
            num_chunks=int(d.get("num_chunks", 8)),
        )

    @classmethod
    def from_json(cls, s: str) -> "U2ModelConfig":
        return cls.from_dict(json.loads(s))


@dataclass(frozen=True)
class DPOConfig:
    """Stage-2 DPO hyperparameters (script/amos_mm_stage2.sh,
    src/train/train_stage2.py:23-86)."""

    beta: float = 0.1
    learning_rate: float = 4e-6
    num_epochs: float = 6.0
    max_prompt_length: int = 512
    max_completion_length: int = 1024
    label_smoothing: float = 0.0
    loss_type: str = "sigmoid"  # sigmoid | ipo
    # WPO weighting (dpo_u2trainer.py:320-329, arXiv 2406.11827 eq. 2)
    use_weighting: bool = False
    # RPO: add alpha * chosen-completion NLL (dpo_u2trainer.py:331-340)
    rpo_alpha: Optional[float] = None
    # chosen and rejected packed into one row with segment-masked
    # attention and restarting positions (TRL's padding-free path), so the
    # prompt and the vision encode run once per sample instead of twice
    packed: bool = False
    # > 0: compute completion log-probs in sequence chunks of this size,
    # never materializing the (2B, S, vocab) logits; unpacked path only
    ce_chunk: int = 0


@dataclass(frozen=True)
class GenerationConfig:
    """Decode parameters: greedy, or with ``do_sample`` top-p sampling at
    ``temperature`` (``ops.sampling``)."""

    max_new_tokens: int = 768
    do_sample: bool = False
    top_p: float = 0.9
    temperature: float = 1.0
    eos_token_id: int = -1
    pad_token_id: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: data (replicas) x fsdp (parameters and optimizer
    state sharded) x tensor (the decoder split), one rank a device
    (``parallel.mesh.make_mesh``)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.tensor


@dataclass(frozen=True)
class TrainConfig:
    """SFT hyperparameters (reference defaults: script/amos_mm_stage1/*.sh,
    src/train/train_stage1.py:95-136)."""

    learning_rate: float = 4e-6
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"
    num_epochs: float = 4.0
    per_device_batch_size: int = 1
    grad_accum_steps: int = 1
    max_steps: Optional[int] = None
    model_max_length: int = 1024
    seed: int = 42
    bf16: bool = True
    # gradient checkpointing of each decoder layer: True or "nothing" =
    # full recompute (minimum memory), "dots_no_batch" keeps the weight
    # matmul outputs, "dots" every matmul output, False or "off" = none
    remat: Union[bool, str] = True
    # > 0: compute the LM loss from hidden states in sequence chunks of
    # this size (never materializing the (B, S, vocab) logits); 0 = plain
    # full-logits loss
    ce_chunk: int = 0
    freeze_vision_tower: bool = False
    freeze_backbone: bool = False
    save_steps: int = 2000
    save_total_limit: int = 2
    log_steps: int = 10
    output_dir: str = "./output/u2-tpu"
    mesh: MeshConfig = field(default_factory=MeshConfig)
