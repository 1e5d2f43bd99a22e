"""The port's continuous-batching slot engine against the JAX package's,
on the CPU in fp32, case by case after ``tests/test_slot_serving.py``
(its 8-device sharded case left out: the port has no meshes yet).

The tiny μ² config, one set of weights in both packages (the port's
seeded initialization, carried to the JAX model as its ``{"params": ...}``
tree by ``weights.flax_params``), requests made from numpy seeds: five
prompts of 5-13 tokens, three with a volume, over two slots, so that
requests are admitted while others decode.

* Engine tokens equal the JAX engine's and the port's single-request
  generate exactly; the int8 cache and slot reuse equal the JAX engine's.
* The pooled slot state (cache, tok, prompt_len, n_gen, active, done)
  equals the JAX engine's after every tick, within 1e-5.
* The speculative engine equals the plain one, with the JAX engine's
  tokens and ``spec_stats``, at block lengths 2 and 8; the adaptive
  ladder visits the JAX engine's rungs tick by tick, and ``_adapt`` walks
  the JAX engine's rungs on scripted acceptance windows.
* ``EngineInference``: concurrent callers, a stream that concatenates to
  ``inference()``, a bad volume shape refused in the caller's thread, an
  engine thread that survives a failing submit and step, grad mode off
  in it, telemetry with the JAX engine's keys (also over HTTP).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import LLMConfig as TLLM
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.models import slot_serving as t_slot
from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
from u2tokenizer_torch.models.llm.decoder import CausalLM as TLM
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_torch.weights import flax_params
from u2tokenizer_tpu.config import GenerationConfig as JGen
from u2tokenizer_tpu.config import LLMConfig as JLLM
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models import slot_serving as j_slot
from u2tokenizer_tpu.models.llm.decoder import CausalLM as JLM
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast

MAX_NEW = 6
PROMPT_BUF = 24
GREEDY = dict(max_new_tokens=MAX_NEW, do_sample=False, eos_token_id=-2,
              pad_token_id=0)
CACHES = {"fp32": (torch.float32, jnp.float32), "int8": ("int8", "int8")}


def _jax_params(tmodel):
    return jax.tree_util.tree_map(jnp.asarray, flax_params(tmodel))


@pytest.fixture(scope="module")
def setup():
    cfg = TCfg.tiny()
    tmodel = TModel(cfg, dtype=torch.float32, device="cpu", seed=0)
    jmodel = JModel(JCfg.tiny(), dtype=jnp.float32)
    params = _jax_params(tmodel)
    rs = np.random.RandomState(0)
    d, h, w = cfg.vision.input_spatial
    img = rs.normal(size=(1, cfg.num_chunks, d, h, w)).astype(np.float32)
    qids = rs.randint(1, cfg.llm.vocab_size, (1, 4))
    requests = []
    for i, plen in enumerate([10, 7, 13, 5, 11]):
        ids = rs.randint(1, cfg.llm.vocab_size, (1, plen))
        use_img = i % 2 == 0
        requests.append((ids, img if use_img else None,
                         qids if use_img else None))
    return cfg, tmodel, jmodel, params, requests


def _t_req(ids, images, qids):
    return (ids, None if images is None else torch.from_numpy(images),
            None if qids is None else torch.from_numpy(qids))


def _j_req(ids, images, qids):
    return (jnp.asarray(ids, jnp.int32),
            None if images is None else jnp.asarray(images),
            None if qids is None else jnp.asarray(qids, jnp.int32))


def _t_engine(setup, cache="fp32", **kw):
    _, tmodel, _, _, _ = setup
    return t_slot.Engine(tmodel, TGen(**GREEDY), num_slots=2,
                         prompt_buf=PROMPT_BUF, cache_dtype=CACHES[cache][0],
                         device="cpu", **kw)


def _j_engine(setup, cache="fp32", **kw):
    _, _, jmodel, params, _ = setup
    return j_slot.Engine(jmodel, params, JGen(**GREEDY), num_slots=2,
                         prompt_buf=PROMPT_BUF, cache_dtype=CACHES[cache][1],
                         **kw)


def _run(engine, requests, to_inputs, trace=None):
    """Submit every request, step to the end; returns the tokens in
    submission order and, with ``trace``, ``trace(engine)`` after each
    tick."""
    rids = [engine.submit(*to_inputs(*r)) for r in requests]
    seen = []
    while engine._queue or engine._by_slot:
        engine.step()
        if trace is not None:
            seen.append(trace(engine))
    return [engine._results[r] for r in rids], seen


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX engine's tokens (and traces) for each variant, computed
    once."""
    cache = {}

    def get(name, cache_dtype="fp32", trace=None, **kw):
        if name not in cache:
            cache[name] = _run(_j_engine(setup, cache_dtype, **kw),
                               setup[4], _j_req, trace)
        return cache[name]
    return get


def _reference_tokens(setup, ids, images, qids):
    """The port's single-request greedy generate (fp32 cache)."""
    cfg, tmodel = setup[:2]
    padded = np.zeros((1, PROMPT_BUF), np.int64)
    padded[0, : ids.shape[1]] = ids[0]
    fn = make_multimodal_generate_fn(tmodel, TGen(**GREEDY),
                                     cache_dtype=torch.float32)
    _, images, qids = _t_req(ids, images, qids)
    return fn(torch.from_numpy(padded), images, qids,
              torch.tensor([ids.shape[1]]))[0].tolist()


def test_engine_matches_jax_and_single_request_generate(setup, jax_runs):
    ours, _ = _run(_t_engine(setup), setup[4], _t_req)
    theirs, _ = jax_runs("plain")
    assert ours == theirs
    for toks, req in zip(ours, setup[4]):
        assert toks == _reference_tokens(setup, *req)


def test_engine_slot_reuse_and_int8(setup, jax_runs):
    requests = setup[4]
    waves = ([requests[0]], [requests[1], requests[2]])
    out = {}
    for name, engine, to_inputs in (
            ("port", _t_engine(setup, "int8"), _t_req),
            ("jax", _j_engine(setup, "int8"), _j_req)):
        # the freed slot serves a second wave
        out[name] = [_run(engine, wave, to_inputs)[0] for wave in waves]
    assert out["port"] == out["jax"]
    assert [len(t) for wave in out["port"] for t in wave] == [MAX_NEW] * 3


def _t_state(engine):
    s = engine.state
    bufs = s.cache.k + s.cache.v
    return ([b.numpy().copy() for b in bufs],
            [x.numpy().copy() for x in (s.tok, s.prompt_len, s.n_gen,
                                        s.active, s.done)])


def _j_state(engine):
    s = engine.state
    bufs = list(s.cache.k) + list(s.cache.v)
    return ([np.asarray(b) for b in bufs],
            [np.asarray(x) for x in (s.tok, s.prompt_len, s.n_gen,
                                     s.active, s.done)])


def test_pooled_cache_matches_jax_after_every_tick(setup, jax_runs):
    _, ours = _run(_t_engine(setup), setup[4], _t_req, trace=_t_state)
    _, theirs = jax_runs("plain_traced", trace=_j_state)
    assert len(ours) == len(theirs) > 10
    for tick, ((ob, of), (jb, jf)) in enumerate(zip(ours, theirs)):
        for a, b in zip(ob, jb):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=f"tick {tick}")
        for a, b in zip(of, jf):
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=f"tick {tick}")


@pytest.mark.parametrize("block_len", [2, 8])
def test_spec_engine_matches_plain_and_jax(setup, jax_runs, block_len):
    plain, _ = _run(_t_engine(setup), setup[4], _t_req)
    engine = _t_engine(setup, speculative=True, block_len=block_len)
    ours, _ = _run(engine, setup[4], _t_req)
    assert ours == plain
    jax_engine = _j_engine(setup, speculative=True, block_len=block_len)
    theirs, _ = _run(jax_engine, setup[4], _j_req)
    assert ours == theirs
    assert engine.spec_stats == jax_engine.spec_stats
    assert engine.spec_stats["verify_steps"] > 0


def test_spec_engine_int8_cache(setup):
    requests = setup[4][:1]
    plain, _ = _run(_t_engine(setup, "int8"), requests, _t_req)
    spec, _ = _run(_t_engine(setup, "int8", speculative=True, block_len=4),
                   requests, _t_req)
    assert spec == plain


def _walk(engine, requests, to_inputs, rung0=None):
    """Run with the rung after every tick: (tokens, modes, sizes)."""
    if rung0 is not None:
        engine._rung = rung0
    toks, seen = _run(engine, requests, to_inputs,
                      trace=lambda e: (e.spec_mode, e.spec_block_len))
    return toks, [m for m, _ in seen], [k for _, k in seen]


ADAPTIVE = {
    # threshold above block_len: every full window steps down; a tiny
    # window and probe_every force several transitions a run
    "flips": dict(spec_threshold=5.0, spec_window=2, probe_every=3),
    "stays": dict(spec_threshold=1.0, spec_window=2, probe_every=3),
    "walks_down": dict(spec_threshold=5.0, spec_window=2, probe_every=100),
    "climbs": dict(spec_threshold=0.0, spec_window=1, probe_every=2,
                   grow_frac=0.0),
}


@pytest.mark.parametrize("policy", sorted(ADAPTIVE))
def test_adaptive_engine_walks_jax_rungs(setup, policy):
    kw = dict(speculative="auto", block_len=4, **ADAPTIVE[policy])
    rung0 = 0 if policy == "climbs" else None
    requests = setup[4][:1] if policy == "stays" else setup[4]
    engine = _t_engine(setup, **kw)
    assert engine.adaptive and engine.speculative
    assert engine._kb_ladder == [1, 2, 4] and engine.spec_mode == "spec"
    toks, modes, sizes = _walk(engine, requests, _t_req, rung0)
    jtoks, jmodes, jsizes = _walk(_j_engine(setup, **kw), requests, _j_req,
                                  rung0)
    assert (toks, modes, sizes) == (jtoks, jmodes, jsizes)
    plain, _ = _run(_t_engine(setup), requests, _t_req)
    assert toks == plain
    if policy == "flips":
        assert "plain" in modes
        assert sum(1 for x, y in zip(modes, modes[1:]) if x != y) >= 2
    elif policy == "stays":
        assert set(modes) == {"spec"}
    elif policy == "walks_down":
        assert 2 in sizes and 1 in sizes
        assert sizes.index(2) < sizes.index(1)
    else:
        assert 4 in sizes


WINDOWS = {
    "demote": [(1, 2)] * 6,
    "promote": [(8, 2)] * 6,
    "mixed": [(3, 2), (2, 2), (8, 2), (1, 2), (2, 1), (9, 2), (2, 2),
              (1, 1), (6, 2), (5, 2)],
    "band": [(23, 20)] * 5,  # acceptance 1.15: in [1.1, 1.2), demotes
}


@pytest.mark.parametrize("windows", sorted(WINDOWS))
def test_adapt_on_scripted_windows(setup, windows):
    engines = (_t_engine(setup, speculative="auto", block_len=8,
                         spec_window=2),
               _j_engine(setup, speculative="auto", block_len=8,
                         spec_window=2))
    rungs = []
    for engine in engines:
        assert engine._kb_ladder == [1, 2, 4, 8]
        engine._rung = 1
        walk = []
        for emitted, steps in WINDOWS[windows]:
            engine._adapt(emitted, steps)
            walk.append(engine._rung)
        rungs.append(walk)
    assert rungs[0] == rungs[1]
    assert len(set(rungs[0])) > 1


def test_spec_slot_fns_refuse_sampling_and_bad_blocks(setup):
    tmodel = setup[1]
    with pytest.raises(ValueError, match="greedy only"):
        t_slot.make_spec_slot_fns(tmodel, TGen(do_sample=True), 2,
                                  PROMPT_BUF, device="cpu")
    _, _, make_decode = t_slot.make_spec_slot_fns(
        tmodel, TGen(**GREEDY), 2, PROMPT_BUF, block_len=4, device="cpu")
    for kbx in (0, 5):
        with pytest.raises(ValueError, match="outside"):
            make_decode(kbx)


def test_engine_runs_on_the_gpu_by_default(setup):
    """Without ``device`` the engine runs on the GPU: here, with none, it
    raises; a model on another device than the engine's is refused."""
    tmodel = setup[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_slot.Engine(tmodel, TGen(**GREEDY), num_slots=2,
                          prompt_buf=PROMPT_BUF)
    with pytest.raises(ValueError, match="parameters are on"):
        t_slot.Engine(tmodel, TGen(**GREEDY), num_slots=2,
                      prompt_buf=PROMPT_BUF, device="meta")


def test_sampled_engine_repeats_its_seed(setup):
    sampled = dict(GREEDY, do_sample=True, top_p=0.9)
    runs = []
    for seed in (3, 3, 4):
        engine = t_slot.Engine(setup[1], TGen(**sampled), num_slots=2,
                               prompt_buf=PROMPT_BUF,
                               cache_dtype=torch.float32, seed=seed,
                               device="cpu")
        runs.append(_run(engine, setup[4], _t_req)[0])
    assert runs[0] == runs[1] != runs[2]


def test_slot_engine_spec_stats_bare_decoder():
    """A bare decoder on the slot pool (``test_serve.py``'s
    ``test_slot_engine_spec_stats``): every token after the prefill's is
    emitted by a verify step, with the JAX engine's counts."""
    tm = TLM(TLLM.tiny(), dtype=torch.float32, device="cpu")
    from u2tokenizer_torch.models.layers import init_weights

    init_weights(tm, 0)
    jm = JLM(JLLM.tiny(), dtype=jnp.float32)
    params = _jax_params(tm)
    gen = dict(max_new_tokens=8, eos_token_id=-2, pad_token_id=0)
    ours = t_slot.Engine(tm, TGen(**gen), num_slots=2, prompt_buf=16,
                         cache_dtype=torch.float32, speculative=True,
                         block_len=4, device="cpu")
    theirs = j_slot.Engine(jm, params, JGen(**gen), num_slots=2,
                           prompt_buf=16, cache_dtype=jnp.float32,
                           speculative=True, block_len=4)
    ours.submit(np.ones((1, 5), np.int64))
    theirs.submit(jnp.ones((1, 5), jnp.int32))
    out, ref = ours.run(), theirs.run()
    assert out == ref and len(out[0]) == 8
    assert ours.spec_stats == theirs.spec_stats
    assert ours.spec_stats["emitted_tokens"] == 7


# --- EngineInference ---

@pytest.fixture
def make_inference(setup):
    made = []

    def make(**kw):
        cfg, tmodel = setup[:2]
        inf = t_slot.EngineInference(
            tmodel, MockTokenizer(), cfg, max_new_tokens=MAX_NEW,
            num_slots=2, prompt_buf=PROMPT_BUF, cache_dtype=torch.float32,
            question_len=4, device="cpu", **kw)
        made.append(inf)
        return inf
    yield make
    for inf in made:
        inf.close()


def _volume(cfg, seed):
    d, h, w = cfg.vision.input_spatial
    return np.random.default_rng(seed).normal(
        size=(cfg.num_chunks, d, h, w)).astype(np.float32)


def test_engine_inference_concurrent_callers(setup, make_inference):
    cfg = setup[0]
    inf = make_inference()
    vols = [_volume(cfg, i) for i in range(3)]
    questions = [f"describe finding number {i}" for i in range(3)]
    results = {}

    def call(i):
        results[i] = inf.inference(vols[i], questions[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert set(results) == {0, 1, 2}
    tok = inf.tokenizer
    for i in range(3):  # the sequential single-request path, exactly
        ids, qids = inf._encode_prompt(questions[i], True)
        ref = _reference_tokens(setup, ids, vols[i][None], qids)
        keep = [t for t in ref if t not in (0, tok.eos_token_id)]
        assert results[i] == tok.decode(keep).strip()


def test_engine_inference_stream_matches(setup, make_inference):
    inf = make_inference()
    vol = _volume(setup[0], 1)
    question = "describe the streamed finding"
    deltas = list(inf.inference_stream(vol, question))
    assert len(deltas) >= 1
    assert "".join(deltas).strip() == inf.inference(vol, question)


def test_engine_inference_rejects_bad_volume_shape(setup, make_inference):
    cfg = setup[0]
    inf = make_inference()
    bad = np.zeros((32, 128, 128), np.float32)  # un-chunked raw volume
    with pytest.raises(ValueError, match="chunk geometry"):
        inf.inference(bad, "describe")
    assert inf.telemetry["pending_submits"] == 0
    good = np.zeros((cfg.num_chunks, *cfg.vision.input_spatial), np.float32)
    assert isinstance(inf.inference(torch.from_numpy(good), "describe"), str)


def test_engine_thread_survives_failures(setup, make_inference, capfd):
    """A failing submit or step fails the affected callers with
    RuntimeError (the step's traceback printed), and the engine keeps
    serving."""
    cfg = setup[0]
    inf = make_inference()
    vol = np.zeros((cfg.num_chunks, *cfg.vision.input_spatial), np.float32)

    orig_submit = inf.engine.submit

    def boom_submit(*a, **k):
        inf.engine.submit = orig_submit
        raise RuntimeError("device lost during submit")
    inf.engine.submit = boom_submit
    with pytest.raises(RuntimeError, match="device lost during submit"):
        inf.inference(vol, "q0")
    assert isinstance(inf.inference(vol, "q1"), str)

    orig_step = inf.engine.step
    calls = {"n": 0}

    def boom_step():
        calls["n"] += 1
        if calls["n"] == 2:  # let the prefill land, then fail a decode
            inf.engine.step = orig_step
            raise RuntimeError("CUDA error: device halted")
        return orig_step()
    inf.engine.step = boom_step
    with pytest.raises(RuntimeError, match="device halted"):
        inf.inference(vol, "q2")
    assert "device halted" in capfd.readouterr().err
    assert "".join(inf.inference_stream(vol, "q3")) != ""
    tele = inf.telemetry
    assert tele["active_slots"] == 0 and tele["queue_depth"] == 0


def test_callers_fail_once_the_engine_thread_stops(setup, make_inference):
    """A caller never waits on a engine thread that has stopped: after
    ``close`` both entry points raise instead of blocking."""
    inf = make_inference()
    inf.close()
    with pytest.raises(RuntimeError, match="engine thread has stopped"):
        inf.inference(None, "a text-only question")
    with pytest.raises(RuntimeError, match="engine thread has stopped"):
        list(inf.inference_stream(None, "a text-only question"))


def test_engine_thread_runs_without_grad(setup, make_inference):
    """Grad mode is per thread: the engine thread enters inference mode itself,
    so a step records no graph even though the model's parameters
    require gradients."""
    inf = make_inference()
    assert next(inf.engine.model.parameters()).requires_grad
    seen = []
    orig_step = inf.engine.step

    def spy():
        seen.append((threading.current_thread() is inf._thread,
                     torch.is_grad_enabled(),
                     torch.is_inference_mode_enabled()))
        out = orig_step()
        state = inf.engine.state
        seen.append(any(t.requires_grad for t in
                        [state.tok, state.n_gen] + state.cache.k))
        return out
    inf.engine.step = spy
    inf.inference(None, "a text-only question")
    assert seen and all(s == (True, False, True) for s in seen[::2])
    assert not any(seen[1::2])


def test_engine_telemetry(setup):
    """telemetry() tracks queue depth, active slots and counters live,
    with the JAX engine's keys, and tokens_per_s goes positive while
    decoding."""
    engine = _t_engine(setup)
    t0 = engine.telemetry()
    assert t0 == {"queue_depth": 0, "active_slots": 0, "num_slots": 2,
                  "completed_requests": 0, "emitted_tokens_total": 0,
                  "tokens_per_s": 0.0, "spec_block_len": 1}
    assert set(t0) == set(_j_engine(setup).telemetry())
    for r in setup[4][:3]:
        engine.submit(*_t_req(*r))
    assert engine.telemetry()["queue_depth"] == 3
    engine.step()  # admit one
    t1 = engine.telemetry()
    assert t1["active_slots"] == 1 and t1["queue_depth"] == 2
    assert t1["emitted_tokens_total"] == 1  # the prefill's first token
    saw_rate = False
    while engine._queue or engine._by_slot:
        engine.step()
        saw_rate = saw_rate or engine.telemetry()["tokens_per_s"] > 0
    tf = engine.telemetry()
    assert tf["completed_requests"] == 3
    assert tf["emitted_tokens_total"] == 3 * MAX_NEW
    assert tf["active_slots"] == 0 and tf["queue_depth"] == 0
    assert saw_rate, "tokens_per_s never went positive while decoding"


def test_engine_telemetry_over_http(setup, make_inference):
    import json
    import urllib.request

    from u2tokenizer_torch.serve import serve_background

    inf = make_inference()
    httpd = serve_background(inf, port=0, transform=False)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/config"
        with urllib.request.urlopen(url, timeout=60) as resp:
            payload = json.loads(resp.read())
        assert payload["concurrent"] is True
        tele = payload["engine"]
        assert tele["num_slots"] == 2
        assert tele["queue_depth"] == 0 and tele["active_slots"] == 0
        assert {"tokens_per_s", "completed_requests", "pending_submits",
                "emitted_tokens_total"} <= set(tele)
    finally:
        httpd.shutdown()
