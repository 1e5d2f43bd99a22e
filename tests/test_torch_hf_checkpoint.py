"""HF-layout checkpoints in and out of the port against the JAX package.

* JAX init -> JAX ``export_u2_state_dict`` -> the port's
  ``convert_u2_checkpoint`` equals the JAX one, key for key, exactly; and
  the port's export of a port model converts (JAX) back to that model's
  own tree, exactly.
* The port's .safetensors reader and writer against the ``safetensors``
  package (imported here only), both ways, BF16 included, and a sharded
  directory with its index.
* ``save_hf_checkpoint`` writes the JAX package's files with the same
  contents, and a ``pytorch_model.bin`` loads like the .safetensors.
* ``u2_config_from_hf`` and ``llm_config_from_hf`` equal the JAX ones.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from safetensors.numpy import load_file as st_load_np
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from u2tokenizer_torch import config as t_config
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models import hf_weights as t_hf
from u2tokenizer_torch.models.safetensors_io import (read_safetensors,
                                                     write_safetensors)
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.weights import flatten, flax_params, load_flax_params
from u2tokenizer_tpu import config as j_config
from u2tokenizer_tpu.models import hf_export as j_export
from u2tokenizer_tpu.models import hf_weights as j_hf
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast


def _cfgs(**u2t):
    jcfg = j_config.U2ModelConfig.tiny()
    jcfg = dataclasses.replace(
        jcfg, u2t=dataclasses.replace(jcfg.u2t, **u2t),
        llm=dataclasses.replace(jcfg.llm, tie_word_embeddings=False))
    return jcfg, t_config.U2ModelConfig.from_dict(dataclasses.asdict(jcfg))


def _jax_params(jcfg):
    d, h, w = jcfg.vision.input_spatial
    return JModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 24), jnp.int32),
        jnp.zeros((1, jcfg.num_chunks, d, h, w)), jnp.zeros((1, 6), jnp.int32))


def _flat_np(tree):
    tree = tree["params"] if "params" in tree else tree
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("u2t", [{}, {"enable_diffts": True,
                                      "enable_dmtp": True}],
                         ids=["default", "diffts_dmtp"])
def test_convert_matches_jax(u2t):
    jcfg, tcfg = _cfgs(**u2t)
    sd = j_export.export_u2_state_dict(_jax_params(jcfg), jcfg)
    ref = _flat_np(j_hf.convert_u2_checkpoint(sd, jcfg))
    as_torch = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    _same_tree(flatten(t_hf.convert_u2_checkpoint(as_torch, tcfg)), ref)
    _same_tree(flatten(t_hf.convert_u2_checkpoint(sd, tcfg)), ref)


def test_port_export_converts_back():
    """Port model -> port export -> JAX convert -> the port model's tree;
    and the tree loads back into a port model bit for bit."""
    jcfg, tcfg = _cfgs(enable_diffts=True, enable_dmtp=True)
    model = TModel(tcfg, dtype=torch.float32, device="cpu", seed=3)
    tree = flax_params(model)
    sd = t_export.export_u2_state_dict(tree, tcfg)
    ref = _flat_np(j_export.export_u2_state_dict(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg))
    assert sorted(sd) == sorted(ref)
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    _same_tree(_flat_np(j_hf.convert_u2_checkpoint(sd, jcfg)),
               flatten(tree))
    other = TModel(tcfg, dtype=torch.float32, device="cpu", seed=4)
    load_flax_params(other, flatten(t_hf.convert_u2_checkpoint(sd, tcfg)))
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 other.named_parameters()):
        assert torch.equal(p, q), name


TENSORS = {"w.f32": torch.randn(5, 3, generator=torch.Generator()
                                .manual_seed(0)),
           "w.bf16": torch.linspace(-3, 3, 24).reshape(4, 6).bfloat16(),
           "w.f16": torch.linspace(-2, 2, 7).half(),
           "q.i8": torch.arange(-6, 6, dtype=torch.int8).reshape(3, 4),
           "n.i32": torch.arange(5, dtype=torch.int32),
           "n.i64": torch.arange(3, dtype=torch.int64) - 1,
           "scalar": torch.tensor(2.5)}


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_safetensors_both_ways(tmp_path):
    st_save(TENSORS, str(tmp_path / "lib.safetensors"))
    _equal(read_safetensors(str(tmp_path / "lib.safetensors")), TENSORS)
    write_safetensors(str(tmp_path / "port.safetensors"), TENSORS)
    _equal(st_load(str(tmp_path / "port.safetensors")), TENSORS)
    numpy_side = st_load_np(str(tmp_path / "port.safetensors"))
    np.testing.assert_array_equal(numpy_side["w.f32"],
                                  TENSORS["w.f32"].numpy())


def test_sharded_dir_and_torch_bin(tmp_path):
    """A directory of shards named by model.safetensors.index.json (a
    stray file beside them is not read), and a pytorch_model.bin."""
    names = sorted(TENSORS)
    shards = {"model-00001-of-00002.safetensors": names[:3],
              "model-00002-of-00002.safetensors": names[3:]}
    for fname, keys in shards.items():
        st_save({k: TENSORS[k] for k in keys}, str(tmp_path / fname))
    st_save({"stray": torch.zeros(1)}, str(tmp_path / "other.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: fname for fname, keys in shards.items()
                                  for k in keys}}, f)
    _equal(t_hf.load_safetensors_dir(str(tmp_path)), TENSORS)
    torch.save(TENSORS, str(tmp_path / "pytorch_model.bin"))
    _equal(t_hf.load_torch_bin(str(tmp_path / "pytorch_model.bin")), TENSORS)


def test_save_hf_checkpoint_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs(enable_diffts=True, enable_dmtp=True)
    params = _jax_params(jcfg)
    j_export.save_hf_checkpoint(str(tmp_path / "jax"), params, jcfg)
    t_export.save_hf_checkpoint(
        str(tmp_path / "port"),
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    for name in ("config.json", "u2_tpu_config.json"):
        with open(tmp_path / "jax" / name) as f, \
                open(tmp_path / "port" / name) as g:
            assert json.load(f) == json.load(g), name
    ours = st_load_np(str(tmp_path / "port" / "model.safetensors"))
    theirs = st_load_np(str(tmp_path / "jax" / "model.safetensors"))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    # the same state dict as a pytorch_model.bin converts the same
    torch.save({k: torch.from_numpy(v) for k, v in ours.items()},
               str(tmp_path / "pytorch_model.bin"))
    _same_tree(flatten(t_hf.convert_u2_checkpoint(
        t_hf.load_torch_bin(str(tmp_path / "pytorch_model.bin")), tcfg)),
        _flat_np(j_hf.convert_u2_checkpoint(theirs, jcfg)))


ROPE = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
HF_CONFIGS = {
    "qwen3": {"model_type": "qwen3", "vocab_size": 151936,
              "hidden_size": 2048, "intermediate_size": 6144,
              "num_hidden_layers": 28, "num_attention_heads": 16,
              "num_key_value_heads": 8, "head_dim": 128,
              "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
              "tie_word_embeddings": True,
              "max_position_embeddings": 40960},
    "llama": {"model_type": "llama", "vocab_size": 128256,
              "hidden_size": 2048, "intermediate_size": 8192,
              "num_hidden_layers": 16, "num_attention_heads": 32,
              "num_key_value_heads": 8, "rope_theta": 500000.0,
              "rms_norm_eps": 1e-5, "rope_scaling": ROPE,
              "tie_word_embeddings": True,
              "max_position_embeddings": 131072},
    # the released μ²Llama-3.2-1B config.json's fields: depth-first
    # geometry, RMA attention (enable_rpe), DiffTS and DMTP
    "released_u2llama": {
        "model_type": "u2Llama", "architectures": ["u2LlamaForCausalLM"],
        "vocab_size": 128260, "hidden_size": 2048,
        "intermediate_size": 8192, "num_hidden_layers": 16,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "head_dim": 64, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
        "rope_scaling": ROPE, "tie_word_embeddings": True,
        "max_position_embeddings": 131072, "image_channel": 1,
        "image_size": [32, 256, 256], "patch_size": [4, 16, 16],
        "vision_tower": "vit3d", "vision_select_layer": -1,
        "vision_select_feature": "patch", "mm_projector_type": "spp",
        "proj_layer_type": "mlp", "proj_layer_num": 2,
        "proj_pooling_type": "spatial", "proj_pooling_size": 2,
        "mm_hidden_size": 768, "enable_u2tokenizer": True,
        "u2t_num_heads": 8, "u2t_num_layers": 4, "u2t_top_k": 1024,
        "use_multi_scale": True, "num_3d_query_token": 256,
        "enable_rpe": True, "enable_diffts": True, "enable_dmtp": True},
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_mapping_matches_jax(name):
    hf = HF_CONFIGS[name]
    assert (dataclasses.asdict(t_hf.llm_config_from_hf(hf))
            == dataclasses.asdict(j_hf.llm_config_from_hf(hf)))
    ours, theirs = t_hf.u2_config_from_hf(hf), j_hf.u2_config_from_hf(hf)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if name == "released_u2llama":
        assert ours.u2t.attn_type == "rma"
        assert ours.u2t.enable_diffts and ours.u2t.enable_dmtp
        assert ours.vision.input_spatial == (32, 256, 256)
        assert ours.proj_out_num == 256
        llama = t_config.LLMConfig.llama_3_2_1b()
        assert ours.llm == dataclasses.replace(
            llama, model_type="llama", max_position_embeddings=131072)
