"""The slice as a whole: a μ² checkpoint directory and a NIfTI volume in,
report text out, through the JAX package's ``U2InferenceModel`` and the
port's, on the CPU in fp32.

A tiny μ² config with DiffTS and DMTP switched on; a checkpoint written by
each package (from seeded weights) and read by both; the volume a seeded
int16 CT in a .nii.gz, through each package's own reader and transform.
Each tokenizer is a ``MockTokenizer`` that knows a word for every id of
the tiny vocabulary, so that the text compares every generated token.
Held: equal text, and the prefill's last-position logits within 1e-4
(fp32, sums in other orders, and the two transforms' outputs 1e-7 apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.data.transforms import U2VolumeTransform as TTransform
from u2tokenizer_torch.eval import inference as t_inf
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models import speculative as t_spec
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train import lora as t_lora
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer as TTok
from u2tokenizer_torch.weights import flatten, flax_params
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.data.transforms import U2VolumeTransform as JTransform
from u2tokenizer_tpu.eval.inference import U2InferenceModel as JInference
from u2tokenizer_tpu.models import generate as j_generate
from u2tokenizer_tpu.models import hf_export as j_export
from u2tokenizer_tpu.models import quantize as j_quant
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.utils.mock_tokenizer import MockTokenizer as JTok

pytestmark = pytest.mark.fast

QUESTION = "Describe the findings of the liver ."
KW = dict(max_length=48, max_new_tokens=10, do_sample=False)


def _tokenizer(cls, vocab):
    tok = cls()
    tok(QUESTION)  # the question's words first, so that they fit
    tok(" ".join(f"w{i}" for i in range(vocab - len(tok.vocab))))
    return tok


def _config():
    cfg = JCfg.tiny()
    return dataclasses.replace(cfg, u2t=dataclasses.replace(
        cfg.u2t, enable_diffts=True, enable_dmtp=True))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A checkpoint written by each package, and a .nii.gz CT."""
    root = tmp_path_factory.mktemp("slice")
    jcfg = _config()
    tcfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    for writer, seed in ((j_export, 4), (t_export, 3)):
        name = "jax_ckpt" if writer is j_export else "port_ckpt"
        params = flax_params(TModel(tcfg, dtype=torch.float32, device="cpu",
                                    seed=seed))
        writer.save_hf_checkpoint(str(root / name), params, tcfg)
    rs = np.random.RandomState(0)
    vol = rs.normal(40.0, 200.0, (44, 40, 30))
    vol[:4], vol[:, :3] = -1000.0, -1000.0
    write_nifti(str(root / "ct.nii.gz"), vol.astype(np.int16))
    return root, jcfg


def _volumes(root, cfg):
    d, h, _ = cfg.vision.input_spatial
    kw = dict(target_size=h, chunk_depth=d, num_chunks=cfg.num_chunks)
    path = str(root / "ct.nii.gz")
    return (JTransform(use_native=False, **kw)(path),
            TTransform(device="cpu", **kw)(path))


def _prefill_logits(jmodel, params, tm, jvol, tvol):
    """The last prompt position's logits of the JAX model and the port's
    U2InferenceModel's."""
    ids, qids, plen = tm._encode_prompt(QUESTION)
    ref = jmodel.apply(params, jnp.asarray(ids[None], jnp.int32),
                         jnp.asarray(jvol[None]),
                         jnp.asarray(qids[None], jnp.int32))[0]
    with torch.no_grad():
        out = tm.model(torch.from_numpy(ids[None]), tvol[None],
                       torch.from_numpy(qids[None]))[0]
    return out[0, plen - 1].numpy(), np.asarray(ref)[0, plen - 1]


@pytest.mark.parametrize("writer", ["jax_ckpt", "port_ckpt"])
def test_report_matches_jax(case, writer):
    root, jcfg = case
    vocab = jcfg.llm.vocab_size
    jm = JInference(str(root / writer), tokenizer=_tokenizer(JTok, vocab),
                    dtype=jnp.float32, **KW)
    tm = t_inf.U2InferenceModel(str(root / writer),
                                tokenizer=_tokenizer(TTok, vocab),
                                dtype=torch.float32, device="cpu", **KW)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    jvol, tvol = _volumes(root, jcfg)
    np.testing.assert_allclose(tvol.numpy(), jvol, rtol=0, atol=1e-4)
    out, ref = _prefill_logits(jm.model, jm.params, tm, jvol, tvol)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    text = tm.inference(tvol, QUESTION)
    assert text == jm.inference(jvol, QUESTION)
    assert len(text.split()) >= 2  # words, not only specials
    if writer == "jax_ckpt":  # the text-only path
        assert tm.inference(None, QUESTION) == jm.inference(None, QUESTION)


def test_int8_weights_match_jax(case):
    """weights="int8": the decoder's weights are those of the JAX
    package's ``quantize_llm_weights`` on the bf16-cast weights, bit for
    bit, and the report is the JAX model's on them. (The JAX package's
    ``U2InferenceModel`` runs that quantization under ``jax.jit``, where
    XLA rounds some scales one ulp apart from the op-by-op result, so it
    is held here op by op.)"""
    root, jcfg = case
    vocab = jcfg.llm.vocab_size
    path = str(root / "port_ckpt")
    jm = JInference(path, tokenizer=_tokenizer(JTok, vocab),
                    dtype=jnp.float32, **KW)
    params = j_quant.quantize_llm_weights(
        j_quant.cast_for_inference(jm.params), mode="int8")
    jmodel = JModel(j_quant.quantized_llm_config(jcfg, "int8"),
                    dtype=jnp.float32)
    tm = t_inf.U2InferenceModel(path, tokenizer=_tokenizer(TTok, vocab),
                                dtype=torch.float32, weights="int8",
                                device="cpu", **KW)
    ours = flatten(flax_params(tm.model))
    theirs = traverse_util.flatten_dict(params["params"], sep="/")
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        np.testing.assert_array_equal(value, np.asarray(theirs[key]),
                                      err_msg=key)
    jvol, tvol = _volumes(root, jcfg)
    out, ref = _prefill_logits(jmodel, params, tm, jvol, tvol)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    ids, qids, plen = tm._encode_prompt(QUESTION)
    jgen = j_generate.make_multimodal_generate_fn(jmodel, jm.gen_cfg)
    ref_tokens = jgen(params, jnp.asarray(ids[None], jnp.int32),
                      jnp.asarray(jvol[None]),
                      jnp.asarray(qids[None], jnp.int32),
                      jnp.asarray([plen], jnp.int32), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(tm.generate_tokens(tvol, QUESTION).numpy(),
                                  np.asarray(ref_tokens)[0])


def test_refusals_and_options(case, monkeypatch):
    """The JAX defaults build the speculative path (``speculative=None``
    follows ``do_sample``); greedy speculative decoding gives the tokens
    of the plain loop; a LoRA directory of zero adapters gives the base's
    tokens; a LoRA directory without its files, unknown weights and a
    missing tokenizer are refused."""
    root, jcfg = case
    path = str(root / "port_ckpt")
    vocab = jcfg.llm.vocab_size
    default = t_inf.U2InferenceModel(path, tokenizer=TTok(), device="cpu")
    assert isinstance(default._gen_fn, t_spec.SpecMultimodalGenerate)
    assert default.gen_cfg.do_sample and default.spec_stats == {
        "emitted_tokens": 0, "verify_steps": 0}
    _, tvol = _volumes(root, jcfg)
    tokens = [t_inf.U2InferenceModel(
        path, tokenizer=_tokenizer(TTok, vocab), dtype=torch.float32,
        device="cpu", speculative=spec, **KW).generate_tokens(tvol, QUESTION)
        for spec in (True, False)]
    torch.testing.assert_close(tokens[0], tokens[1], rtol=0, atol=0)
    # a LoRA directory whose adapters are zero folds in as the base; one
    # with its files missing raises as the JAX package's does
    lora = {"params/llm/model/layers_0/self_attn/q_proj/kernel": {
        "a": torch.ones(jcfg.llm.hidden_size, 2),
        "b": torch.zeros(2, jcfg.llm.num_heads * jcfg.llm.head_dim)}}
    t_lora.save_lora_dir(path + "_lora", lora, t_lora.LoraConfig(2, 4))
    zero = t_inf.U2InferenceModel(
        path, tokenizer=_tokenizer(TTok, vocab), dtype=torch.float32,
        device="cpu", lora_path=path + "_lora", **KW)
    torch.testing.assert_close(zero.generate_tokens(tvol, QUESTION),
                               tokens[1], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        t_inf.U2InferenceModel(path, tokenizer=TTok(), do_sample=False,
                               lora_path=path, device="cpu")
    with pytest.raises(ValueError, match="weights"):
        t_inf.U2InferenceModel(path, tokenizer=TTok(), do_sample=False,
                               weights="fp8", device="cpu")
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(ImportError, match="tokenizer="):
        t_inf.U2InferenceModel(path, do_sample=False, device="cpu")
    tm = t_inf.U2InferenceModel(path, tokenizer=TTok(), device="cpu", **KW)
    with pytest.raises(ValueError, match="chunk geometry"):
        tm.inference(np.zeros((1, 2, 3, 4), np.float32), QUESTION)


def test_sampled_reports_repeat_with_the_seed(case):
    root, jcfg = case
    vocab = jcfg.llm.vocab_size
    _, tvol = _volumes(root, jcfg)
    texts = [t_inf.U2InferenceModel(
        str(root / "port_ckpt"), tokenizer=_tokenizer(TTok, vocab),
        dtype=torch.float32, device="cpu", seed=seed, speculative=False,
        **dict(KW, do_sample=True)).inference(tvol, QUESTION)
        for seed in (5, 5, 6)]
    assert texts[0] == texts[1] and texts[0] != texts[2]


def test_default_sampled_report_and_spec_stats(case):
    """``U2InferenceModel`` with the JAX defaults (sampled, speculative)
    returns a report on the CPU, and its ``spec_stats`` count as the JAX
    package's do: emitted tokens after the first, up to the first EOS,
    and verify steps. The JAX package's own sampled draws differ (other
    generators), so its counts are held on greedy speculative decoding,
    where both packages emit the same tokens in the same steps."""
    root, jcfg = case
    vocab = jcfg.llm.vocab_size
    path = str(root / "port_ckpt")
    jvol, tvol = _volumes(root, jcfg)
    kw = dict(KW, max_new_tokens=24)
    kw.pop("do_sample")
    tm = t_inf.U2InferenceModel(path, tokenizer=_tokenizer(TTok, vocab),
                                dtype=torch.float32, device="cpu", seed=2,
                                **kw)
    text = tm.inference(tvol, QUESTION)
    assert text and tm._speculative
    stats = dict(tm.spec_stats)
    tokens = t_inf.U2InferenceModel(
        path, tokenizer=_tokenizer(TTok, vocab), dtype=torch.float32,
        device="cpu", seed=2, **kw).generate_tokens(tvol, QUESTION)
    eos = (tokens == 1).nonzero()
    emitted = int(eos[0, 0]) + 1 if len(eos) else len(tokens)
    assert stats["emitted_tokens"] == emitted - 1
    assert (emitted - 1) / 8 <= stats["verify_steps"] <= emitted - 1

    greedy = dict(kw, do_sample=False, speculative=True)
    jm = JInference(path, tokenizer=_tokenizer(JTok, vocab),
                    dtype=jnp.float32, **greedy)
    tg = t_inf.U2InferenceModel(path, tokenizer=_tokenizer(TTok, vocab),
                                dtype=torch.float32, device="cpu", **greedy)
    assert tg.inference(tvol, QUESTION) == jm.inference(jvol, QUESTION)
    assert tg.spec_stats == jm.spec_stats
    assert tg.spec_stats["verify_steps"] > 0


def test_validity_filter_and_chat_format():
    from u2tokenizer_tpu.eval import inference as j_inf

    for text in ("short", "a" * 25, "影像" + "b" * 30):
        assert (t_inf.check_character_and_length(text)
                == j_inf.check_character_and_length(text))
    assert t_inf.green_chat_format("p") == j_inf.green_chat_format("p")
    check = t_inf.AnswerValidator(lambda prompt: " yes.")
    assert check("q", "a") and t_inf.AnswerValidator.PROMPT == \
        j_inf.AnswerValidator.PROMPT
