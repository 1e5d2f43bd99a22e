"""The port's HTTP server and CLI against the JAX package's, with real
HTTP requests, on the CPU in fp32, after ``tests/test_serve.py``.

One tiny μ² checkpoint (seeded weights written by the port's
``save_hf_checkpoint``) is served greedily by each package's
``U2InferenceModel``, each package's slot engine (``EngineInference``,
two slots) and, for the OpenAI routes, each package's ``TextLMServer``
over one tiny decoder; each package has its own ``MockTokenizer`` that
knows a word for every id of the vocabulary (the requests' words
first), so that texts compare every generated token. Every route of
``test_serve.py`` gives the same status and JSON keys in both, report
and chat texts are equal, bad requests get the same codes, SSE framing
is the same, a streamed report concatenates to the blocking one, and an
uploaded volume's slice PNG has the same bytes. The CLI's ``serve`` and
``serve-llm`` parse and build what they serve. Left out:
``test_llm_server_closes_synthesis_loop`` (``data/synthesis.py`` is not
ported).
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch import serve as t_serve
from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.data.transforms import U2VolumeTransform as TTransform
from u2tokenizer_torch.eval.inference import U2InferenceModel as TInference
from u2tokenizer_torch.models import slot_serving as t_slot
from u2tokenizer_torch.models.hf_export import save_hf_checkpoint
from u2tokenizer_torch.models.layers import init_weights
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer as TTok
from u2tokenizer_torch.weights import flax_params
from u2tokenizer_tpu import serve as j_serve
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.data.transforms import U2VolumeTransform as JTransform
from u2tokenizer_tpu.eval.inference import U2InferenceModel as JInference
from u2tokenizer_tpu.models import slot_serving as j_slot
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.utils.mock_tokenizer import MockTokenizer as JTok

pytestmark = pytest.mark.fast

# every word the requests below send, registered before the vocabulary is
# filled, so that each tokenizer maps them to the same ids
WORDS = ("describe findings what do you see ? hi hello scan count to four "
         "the x streamed report q")
KW = dict(max_length=32, max_new_tokens=4, do_sample=False)


def _tokenizer(cls, vocab):
    tok = cls()
    tok(WORDS)
    tok(" ".join(f"w{i}" for i in range(vocab - len(tok.vocab))))
    return tok


def _http(url, payload=None, data=None, headers=None):
    """(status, content type, body bytes) of a GET (no payload) or POST;
    HTTP errors are returned, not raised."""
    if payload is not None:
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _both(servers, path, payload=None, **kw):
    """The same request to the port's and the JAX package's server."""
    return [_http(url + path, payload, **kw) for url in servers]


def _json(reply):
    return json.loads(reply[2])


def _start(lib, model, transform):
    httpd = lib.serve_background(model, port=0, transform=transform)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Port and JAX servers: the report model, the slot engine and a text
    LM; a checkpoint directory and a .nii.gz volume."""
    tmp = tmp_path_factory.mktemp("serve")
    jcfg = JCfg.tiny()
    tcfg = TCfg.from_dict(dataclasses.asdict(jcfg))
    ckpt = str(tmp / "ckpt")
    save_hf_checkpoint(ckpt, flax_params(
        TModel(tcfg, dtype=torch.float32, device="cpu", seed=0)), tcfg)
    vocab = tcfg.llm.vocab_size
    d, h, w = tcfg.vision.input_spatial
    geo = dict(target_size=h, chunk_depth=d, num_chunks=tcfg.num_chunks)
    vol_path = str(tmp / "case.nii.gz")
    write_nifti(vol_path, np.random.default_rng(0)
                .uniform(-100, 400, (24, 28, 12)).astype(np.float32))

    tm = TInference(ckpt, tokenizer=_tokenizer(TTok, vocab),
                    model_config=tcfg, dtype=torch.float32, device="cpu",
                    **KW)
    jm = JInference(ckpt, tokenizer=_tokenizer(JTok, vocab),
                    model_config=jcfg, dtype=jnp.float32, **KW)
    t_eng = t_slot.EngineInference(
        tm.model, _tokenizer(TTok, vocab), tm.cfg, max_new_tokens=4,
        num_slots=2, prompt_buf=32, cache_dtype=torch.float32,
        device="cpu")
    j_eng = j_slot.EngineInference(
        jm.model, jm.params, _tokenizer(JTok, vocab), jm.cfg,
        max_new_tokens=4, num_slots=2, prompt_buf=32,
        cache_dtype=jnp.float32)

    lm = TLM(TLLM.tiny(), dtype=torch.float32, device="cpu")
    init_weights(lm, 1)
    t_lm = t_serve.TextLMServer(lm, _tokenizer(TTok, 512), max_new_tokens=4,
                                max_length=32, name="tiny-test-llm",
                                device="cpu")
    j_lm = j_serve.TextLMServer(
        JLM(JLLM.tiny(), dtype=jnp.float32),
        jax.tree_util.tree_map(jnp.asarray, flax_params(lm)),
        _tokenizer(JTok, 512), max_new_tokens=4, max_length=32,
        name="tiny-test-llm")

    started = {
        "report": [_start(t_serve, tm, TTransform(device="cpu", **geo)),
                   _start(j_serve, jm, JTransform(use_native=False, **geo))],
        "engine": [_start(t_serve, t_eng, TTransform(device="cpu", **geo)),
                   _start(j_serve, j_eng, JTransform(use_native=False,
                                                     **geo))],
        "llm": [_start(t_serve, t_lm, False), _start(j_serve, j_lm, False)],
    }
    yield ({k: [url for _, url in v] for k, v in started.items()},
           vol_path, ckpt, t_lm)
    for pair in started.values():
        for httpd, _ in pair:
            httpd.shutdown()
    t_eng.close()


def _same(replies, keys_only=False):
    """Same status and content type; the same JSON (or, with
    ``keys_only``, the same keys) in both replies."""
    (s1, c1, b1), (s2, c2, b2) = replies
    assert (s1, c1) == (s2, c2)
    j1, j2 = json.loads(b1), json.loads(b2)
    if keys_only:
        assert set(j1) == set(j2)
    else:
        assert j1 == j2
    return j1


def test_health(stack):
    servers = stack[0]
    for kind in ("report", "engine", "llm"):
        assert _same(_both(servers[kind], "/health")) == {"status": "ok"}


@pytest.mark.parametrize("kind", ["report", "engine"])
def test_report_endpoint(stack, kind):
    servers, vol = stack[0][kind], stack[1]
    out = _same(_both(servers, "/v1/report",
                      {"image_path": vol, "question": "describe findings"}),
                keys_only=True)
    ours, theirs = (_json(r) for r in _both(
        servers, "/v1/report", {"image_path": vol,
                                "question": "describe findings"}))
    assert ours["report"] == theirs["report"]
    assert len(ours["report"].split()) >= 2 and out["latency_s"] >= 0


BAD = [
    ("/v1/report", {"question": "no image"}),
    ("/v1/report", {"image_path": "/missing.nii.gz", "question": "q"}),
    ("/v1/report", {"volume_id": "vol-nope", "question": "q"}),
    ("/v1/nothing", {}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "x"}], "n": 99}),
    ("/v1/completions", {"prompt": "x", "n": 99}),
    ("/v1/completions", {"prompt": "x", "n": 2, "stream": True}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "x"}], "n": 2,
      "stream": True}),
]


@pytest.mark.parametrize("path,payload", BAD,
                         ids=[f"{p}-{sorted(q)}" for p, q in BAD])
def test_bad_requests_get_jax_codes(stack, path, payload):
    replies = _both(stack[0]["report"], path, payload)
    assert replies[0][0] == replies[1][0] >= 400
    assert set(_json(replies[0])) == set(_json(replies[1])) == {"error"}


def test_invalid_json_and_unknown_get(stack):
    for kind in ("report", "llm"):
        replies = _both(stack[0][kind], "/v1/report", data=b"{not json",
                        headers={"Content-Type": "application/json"})
        assert replies[0][0] == replies[1][0] == 400
        assert _same(replies) == {"error": "invalid JSON"}
        assert _same(_both(stack[0][kind], "/v1/elsewhere")) == {
            "error": "not found"}
        replies = _both(stack[0][kind], "/v1/volume/x/slice/notanint")
        assert replies[0][0] == replies[1][0] == 400


def test_llm_server_openai_protocol(stack):
    servers = stack[0]["llm"]
    out = _same(_both(servers, "/v1/completions",
                      {"prompt": "describe the findings"}))
    assert isinstance(out["choices"][0]["text"], str)
    out = _same(_both(servers, "/v1/chat/completions",
                      {"messages": [{"role": "user", "content": "hi"}]}))
    assert out["choices"][0]["message"]["role"] == "assistant"
    models = _same(_both(servers, "/v1/models"))
    assert models["data"][0]["id"] == "tiny-test-llm"


def test_llm_server_n_choices(stack):
    """OpenAI ``n``: n choices with distinct indices; the greedy server's
    choices are one decode, copied."""
    out = _same(_both(stack[0]["llm"], "/v1/chat/completions",
                      {"messages": [{"role": "user", "content": "hi"}],
                       "n": 3}))
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    texts = [c["message"]["content"] for c in out["choices"]]
    assert texts[0] == texts[1] == texts[2]


def test_llm_server_sampled_n_fanout():
    """A sampled TextLMServer decodes n choices in one fan-out call; the
    choices differ (tiny random model, near-uniform logits)."""
    lm = TLM(TLLM.tiny(), dtype=torch.float32, device="cpu")
    init_weights(lm, 0)

    class IdTok(TTok):
        # decode to raw ids: MockTokenizer maps unseen ids to "<unk>"
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    server = t_serve.TextLMServer(lm, IdTok(), max_new_tokens=6,
                                  max_length=32, do_sample=True, top_p=0.95,
                                  speculative=False, device="cpu")
    texts = server.text_completion_n("describe the findings", 4)
    assert len(texts) == 4 and len(set(texts)) > 1
    assert 4 in server._fan_cache
    # each call draws from a generator seeded with the call count
    again = t_serve.TextLMServer(lm, IdTok(), max_new_tokens=6,
                                 max_length=32, do_sample=True, top_p=0.95,
                                 speculative=False, device="cpu")
    assert again.text_completion_n("describe the findings", 4) == texts


def test_llm_server_spec_acceptance_telemetry(stack):
    """The greedy TextLMServer decodes speculatively by default, with the
    JAX package's acceptance counts in /v1/config."""
    servers = stack[0]["llm"]
    _same(_both(servers, "/v1/completions", {"prompt": "count to four"}))
    cfg = _same(_both(servers, "/v1/config"))
    assert cfg["speculative"] is True
    stats = cfg["spec_stats"]
    assert stats["verify_steps"] >= 1 and stats["emitted_tokens"] >= 1
    assert stats["mean_accept_per_step"] == pytest.approx(
        stats["emitted_tokens"] / stats["verify_steps"], abs=0.01)


@pytest.mark.parametrize("kind", ["report", "llm"])
def test_index_page_served(stack, kind):
    (s1, c1, b1), (s2, c2, b2) = _both(stack[0][kind], "/")
    assert (s1, c1, b1) == (s2, c2, b2) and s1 == 200
    body = b1.decode()
    for needle in ("<html", "/v1/report", "/v1/upload", "slice", "slider",
                   "type=\"file\"", "/v1/config"):
        assert needle in body, needle


def _sse(reply):
    status, ctype, body = reply
    lines = body.decode().splitlines()
    chunks = [ln[len("data: "):] for ln in lines if ln.startswith("data: ")]
    assert status == 200 and chunks and chunks[-1] == "[DONE]"
    assert all(ln.startswith("data: ") or ln == "" for ln in lines)
    return ctype, [json.loads(c) for c in chunks[:-1]]


@pytest.mark.parametrize("kind", ["report", "engine", "llm"])
def test_chat_stream_sse(stack, kind):
    replies = _both(stack[0][kind], "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello scan"}],
        "stream": True})
    (c1, ours), (c2, theirs) = (_sse(r) for r in replies)
    assert c1 == c2 and c1.startswith("text/event-stream")
    text = lambda chunks: "".join(c["choices"][0]["delta"]["content"]
                                  for c in chunks)
    assert text(ours) == text(theirs)
    assert all(set(c["choices"][0]) == {"delta", "index", "finish_reason"}
               for c in ours)


@pytest.mark.parametrize("kind", ["report", "engine"])
def test_report_stream_sse(stack, kind):
    servers, vol = stack[0][kind], stack[1]
    payload = {"image_path": vol, "question": "what do you see ?"}
    replies = _both(servers, "/v1/report", dict(payload, stream=True))
    (_, ours), (_, theirs) = (_sse(r) for r in replies)
    streamed = "".join(c["report_delta"] for c in ours)
    assert streamed == "".join(c["report_delta"] for c in theirs)
    blocking = _json(_http(servers[0] + "/v1/report", payload))["report"]
    assert streamed.strip() == blocking
    if kind == "engine":  # true token streaming: a delta a token
        assert len(ours) == len(theirs) >= 2


def test_upload_slice_viewer_and_config(stack):
    servers, vol = stack[0]["report"], stack[1]
    with open(vol, "rb") as f:
        data = f.read()
    info = _same(_both(servers, "/v1/upload", data=data, headers={
        "Content-Type": "application/octet-stream",
        "X-Filename": "case.nii.gz"}))
    assert info["volume_id"].startswith("vol-") and info["chunks"] >= 1
    for index in (0, 17, 10 ** 6):
        (s1, c1, png), (s2, c2, ref) = _both(
            servers, f"/v1/volume/{info['volume_id']}/slice/{index}")
        assert (s1, c1) == (s2, c2) == (200, "image/png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and png == ref
    replies = _both(servers, "/v1/volume/vol-nope/slice/0")
    assert replies[0][0] == replies[1][0] == 404
    ours, theirs = (_json(r) for r in _both(
        servers, "/v1/report", {"volume_id": info["volume_id"],
                                "question": "describe findings"}))
    assert ours["report"] == theirs["report"]
    cfg = _same(_both(servers, "/v1/config"))
    assert cfg == {"weights": "bf16", "speculative": False,
                   "concurrent": False, "max_new_tokens": 4}


def test_npy_upload_and_engine_config(stack):
    """A preprocessed .npy upload is kept as it is (the same slice bytes);
    the slot engine's /v1/config carries its telemetry."""
    servers = stack[0]["engine"]
    d, h, w = TCfg.tiny().vision.input_spatial
    arr = np.random.default_rng(2).uniform(
        0, 1, (TCfg.tiny().num_chunks, d, h, w)).astype(np.float32)
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    info = _same(_both(servers, "/v1/upload", data=buf.getvalue(), headers={
        "Content-Type": "application/octet-stream",
        "X-Filename": "case.npy"}))
    (_, _, png), (_, _, ref) = _both(
        servers, f"/v1/volume/{info['volume_id']}/slice/3")
    assert png == ref == t_serve.encode_gray_png(arr[0, 3])
    cfg = _same(_both(servers, "/v1/config"), keys_only=True)
    assert cfg["concurrent"] is True
    (_, _, b1), (_, _, b2) = _both(servers, "/v1/config")
    assert set(json.loads(b1)["engine"]) == set(json.loads(b2)["engine"])


def test_encode_gray_png_matches_jax():
    img = np.random.default_rng(3).normal(size=(13, 21)).astype(np.float32)
    png = t_serve.encode_gray_png(img)
    assert png == j_serve.encode_gray_png(img)
    assert t_serve.encode_gray_png(torch.from_numpy(img)) == png


def _serve_args(ckpt, *extra):
    return t_cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--checkpoint", ckpt,
         "--max-new-tokens", "4", "--max-length", "32", *extra])


def test_cli_serve_builds_the_slot_engine(stack):
    servers, vol, ckpt = stack[0]["engine"], stack[1], stack[2]
    args = _serve_args(ckpt, "--slots", "2")
    assert (args.slots, args.device, args.port) == (2, "cpu", 8088)
    model = t_cli.build_served_model(args, tokenizer=_tokenizer(TTok, 512))
    try:
        assert isinstance(model, t_slot.EngineInference)
        assert model.engine.num_slots == 2 and not model.speculative
        httpd, url = _start(t_serve, model, TTransform(
            device="cpu", target_size=32, chunk_depth=16, num_chunks=2))
        try:
            payload = {"image_path": vol, "question": "describe findings"}
            assert _json(_http(url + "/v1/report", payload)) ["report"] == \
                _json(_http(servers[0] + "/v1/report", payload))["report"]
        finally:
            httpd.shutdown()
    finally:
        model.close()
    auto = t_cli.build_served_model(
        _serve_args(ckpt, "--slots", "2", "--speculative", "auto"))
    try:
        assert auto.engine.adaptive
    finally:
        auto.close()


def test_cli_serve_single_request_model(stack):
    model = t_cli.build_served_model(_serve_args(stack[2]))
    assert isinstance(model, TInference) and model.device.type == "cpu"
    assert (model.gen_cfg.max_new_tokens, model.weights) == (4, "bf16")


def test_cli_serve_llm_builds(stack):
    args = t_cli.build_parser().parse_args(
        ["serve-llm", "--preset", "tiny", "--device", "cpu",
         "--max-new-tokens", "4"])
    server = t_cli.build_llm_server(args, tokenizer=_tokenizer(TTok, 512))
    assert server.name == "tiny" and server.device.type == "cpu"
    assert server._speculative  # greedy: speculative by default
    weight = server.model.model.layers[0].mlp.up_proj.weight
    assert weight.dtype == torch.bfloat16 and weight.abs().sum() > 0
    assert isinstance(server.text_completion("count to four"), str)
    with pytest.raises(NotImplementedError, match="parallel"):
        t_cli.build_llm_server(t_cli.build_parser().parse_args(
            ["serve-llm", "--device", "cpu", "--tensor-parallel", "2"]))


def test_cli_serve_llm_reads_a_model_dir(stack, tmp_path):
    """--model-dir: an HF decoder checkpoint (config.json + safetensors)
    gives the weights it was written from."""
    from u2tokenizer_torch.models.safetensors_io import write_safetensors

    t_lm = stack[3]
    cfg = TLLM.tiny()
    hf = {"model.embed_tokens.weight": t_lm.model.model.embed_tokens,
          "model.norm.weight": t_lm.model.model.norm.weight}
    for i, layer in enumerate(t_lm.model.model.layers):
        p = f"model.layers.{i}."
        for name, mod in (("self_attn.q_proj", layer.self_attn.q_proj),
                          ("self_attn.k_proj", layer.self_attn.k_proj),
                          ("self_attn.v_proj", layer.self_attn.v_proj),
                          ("self_attn.o_proj", layer.self_attn.o_proj),
                          ("mlp.gate_proj", layer.mlp.gate_proj),
                          ("mlp.up_proj", layer.mlp.up_proj),
                          ("mlp.down_proj", layer.mlp.down_proj)):
            hf[p + name + ".weight"] = mod.weight
        hf[p + "input_layernorm.weight"] = layer.input_layernorm.weight
        hf[p + "post_attention_layernorm.weight"] = \
            layer.post_attention_layernorm.weight
        if cfg.qk_norm:
            hf[p + "self_attn.q_norm.weight"] = layer.self_attn.q_norm.weight
            hf[p + "self_attn.k_norm.weight"] = layer.self_attn.k_norm.weight
    write_safetensors(str(tmp_path / "model.safetensors"),
                      {k: v.detach().float() for k, v in hf.items()})
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": cfg.model_type, "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings}))
    args = t_cli.build_parser().parse_args(
        ["serve-llm", "--model-dir", str(tmp_path), "--device", "cpu"])
    server = t_cli.build_llm_server(args, tokenizer=_tokenizer(TTok, 512))
    assert server.name == str(tmp_path)
    theirs = dict(t_lm.model.named_parameters())
    for name, p in server.model.named_parameters():
        want = theirs[name].detach().to(p.dtype)
        assert torch.equal(p.detach(), want), name
