"""The port's initializers against the JAX package's, on the CPU.

``reset_parameters`` draws from a ``torch.Generator`` and the JAX package
from ``jax.random``, so the numbers differ; the distributions must not.
Each case draws a large tensor from the port's module and one of the same
size from the flax initializer its JAX module names, and holds the port's
draw to the flax draw's bounds and, within 1 %, to its std. Beside them,
two defaults the port had apart from the JAX package: the generate entry
points' KV cache, and ``LLMConfig.quantized_weights``, which the port
serves.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from u2tokenizer_torch.config import LLMConfig, SegConfig, VisionConfig
from u2tokenizer_torch.models import generate as t_generate
from u2tokenizer_torch.models.llm.decoder import CausalLM
from u2tokenizer_torch.models import seg as t_seg
from u2tokenizer_torch.models.layers import Dense
from u2tokenizer_torch.models.u2tok.svr import DynamicMultiScalePooling
from u2tokenizer_torch.models.vit3d import PatchEmbed3D, _ConvProj
from u2tokenizer_tpu.models import generate as j_generate

pytestmark = pytest.mark.fast

N_IN, N_OUT = 256, 4096  # 1 M values a draw: the std is known to ~0.1 %
# lecun_normal draws stddev * truncated_normal(-2, 2) with stddev =
# (1/fan_in)^(1/2) / 0.87962566 (flax's variance_scaling)
LECUN_BOUND = 2 * N_IN ** -0.5 / 0.87962566103423978


def _dense():
    m = Dense(N_IN, N_OUT)
    return (m, m.weight, (N_IN, N_OUT), nn.initializers.lecun_normal(),
            LECUN_BOUND)


def _conv_proj():
    m = _ConvProj(N_OUT, (4, 4, 4), 4)  # flat fan-in 4*4*4*4 = 256
    return (m, m.kernel, (N_IN, N_OUT), nn.initializers.lecun_normal(),
            LECUN_BOUND)


def _position_embeddings():
    m = PatchEmbed3D(VisionConfig())  # (1, 2048, 768): 1.6 M values
    return (m, m.position_embeddings, tuple(m.position_embeddings.shape),
            nn.initializers.truncated_normal(stddev=0.02, lower=-2.0,
                                             upper=2.0), 0.04)


def _dmtp_gate():
    # DMTP's (E, 1) gate kernel: E = 2^20 inputs, so one draw holds 1 M
    # values (fan-in 2^20)
    m = DynamicMultiScalePooling(1 << 20)
    return (m, m.gate_kernel, (1 << 20, 1), nn.initializers.lecun_normal(),
            2 * 2.0 ** -10 / 0.87962566103423978)


def _conv_transpose():
    # the seg head's (2, 2, 2, in, out) kernel: flax's fan-in is 8 * in = 256
    m = t_seg.ConvTranspose3d(32, 4096)
    return (m, m.kernel, (2, 2, 2, 32, 4096), nn.initializers.lecun_normal(),
            LECUN_BOUND)


@pytest.mark.parametrize("make", [_dense, _conv_proj, _position_embeddings,
                                  _dmtp_gate, _conv_transpose],
                         ids=["Dense", "_ConvProj", "position_embeddings",
                              "DMTP gate_kernel", "seg ConvTranspose3d"])
def test_init_matches_flax(make):
    module, param, jax_shape, init, bound = make()
    with torch.no_grad():
        module.reset_parameters(torch.Generator().manual_seed(0))
    ours = param.detach().double().numpy().ravel()
    theirs = np.asarray(init(jax.random.PRNGKey(0), jax_shape,
                             jnp.float32), np.float64).ravel()
    assert ours.size == theirs.size >= 10 ** 6
    # truncated at two stds of the untruncated normal: neither draw goes
    # beyond, and both reach close to the bound
    for x in (ours, theirs):
        assert 0.99 * bound <= np.abs(x).max() <= bound * (1 + 1e-6)
    assert abs(ours.std() / theirs.std() - 1) <= 0.01
    assert abs(ours.mean()) <= 0.01 * theirs.std()


# The seg head's plain normals (flax's initializers.normal: untruncated):
# (module, parameter name, std). The encoder's position embedding without
# blocks holds 1.6 M values; the others are held at their own sizes.
SEG_NORMALS = [
    (lambda: t_seg.SegImageEncoder3D(SegConfig(encoder_layers=0)),
     "pos_embed", 0.02),
    (lambda: t_seg.PromptEncoder3D(SegConfig()), "pe_gaussian", 1.0),
    (lambda: t_seg.PromptEncoder3D(SegConfig()), "no_mask_embed", 0.02),
    (lambda: t_seg.MaskDecoder3D(SegConfig(decoder_layers=0)), "iou_token",
     0.02),
    (lambda: t_seg.MaskDecoder3D(SegConfig(decoder_layers=0)), "mask_token",
     0.02),
]


@pytest.mark.parametrize("make,name,std", SEG_NORMALS,
                         ids=[n for _, n, _ in SEG_NORMALS])
def test_seg_normal_inits_match_flax(make, name, std):
    module = make()
    with torch.no_grad():
        module.reset_parameters(torch.Generator().manual_seed(0))
    ours = getattr(module, name).detach().double().numpy().ravel()
    theirs = np.asarray(nn.initializers.normal(std)(
        jax.random.PRNGKey(0), (ours.size,), jnp.float32), np.float64)
    spread = 5 / np.sqrt(ours.size)  # five standard errors of a std
    for x in (ours, theirs):
        assert abs(x.std() / std - 1) <= spread
        assert abs(x.mean()) <= spread * std
    if ours.size >= 10 ** 6:  # untruncated: past two stds, as flax's
        assert np.abs(ours).max() > 4 * std
        assert np.abs(theirs).max() > 4 * std


def test_generate_default_cache_is_bf16():
    """The port's generate entry points default to a bf16 KV cache, as the
    JAX package's default to jnp.bfloat16."""
    for name in ("make_generate_fn", "make_multimodal_generate_fn",
                 "make_seg_generate_fn"):
        j = inspect.signature(getattr(j_generate, name)).parameters
        assert j["cache_dtype"].default == jnp.bfloat16
    for obj in (t_generate.Generate, t_generate.make_generate_fn,
                t_generate.MultimodalGenerate,
                t_generate.make_multimodal_generate_fn,
                t_generate.SegGenerate, t_generate.make_seg_generate_fn):
        default = inspect.signature(obj).parameters["cache_dtype"].default
        assert default is torch.bfloat16, (obj, default)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_config_quantized_weights_are_served(mode):
    """``LLMConfig.quantized_weights`` is served, not only carried: the
    decoder's projections hold the quantized layout it names."""
    cfg = dataclasses.replace(LLMConfig.tiny(), quantized_weights=mode)
    proj = CausalLM(cfg, dtype=torch.float32,
                    device="cpu").model.layers[0].mlp.gate_proj
    assert proj.mode == mode and proj.weight.dtype == torch.int8
