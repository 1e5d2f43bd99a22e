"""The port's GREEN scorer (``u2tokenizer_torch/eval/green.py``) against
the JAX package's, on the CPU.

The parsers, the score and the prompt are pure Python: equal on the judge
responses of ``tests/test_green.py`` and on the fixture bank of
``tests/fixtures/green_responses``. The port's TF-IDF is held to
scikit-learn's ``TfidfVectorizer`` within 1e-12 (float64, the same
formula in another order of sums), its silhouette score to scikit-learn's
within 1e-12, and its k-means and largest cluster to the JAX package's
(scikit-learn's) on well-separated sentence sets, where the partition is
the data's. The JAX package would embed with sentence-transformers when it
is installed, which downloads a checkpoint; these tests hide it, so that
the JAX package takes its TF-IDF path. ``GreenScorer`` with a stub judge
gives the JAX package's ``GreenResult``; ``OpenAIBatchJudge`` runs the
batch-file workflow against a local mock server. ``TorchJudge``'s greedy
tokens are those of the port's ``make_generate_fn`` (which
``tests/test_torch_prefill_variants.py`` holds to the JAX package's,
shared-prefix prefill included), the same with
speculative decoding and the shared-prefix prefill on or off.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from test_green import (RESPONSE_LETTERS, RESPONSE_NO_ERRORS,
                        RESPONSE_NO_MATCH, RESPONSE_NUMBERS)

from u2tokenizer_torch.eval import green as t_green
from u2tokenizer_tpu.eval import green as j_green

pytestmark = pytest.mark.fast

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures",
                      "green_responses")
FIXTURES = sorted(f for f in os.listdir(FIXDIR) if f.endswith(".txt"))
INLINE = {"letters": RESPONSE_LETTERS, "numbers": RESPONSE_NUMBERS,
          "no_errors": RESPONSE_NO_ERRORS, "no_match": RESPONSE_NO_MATCH,
          "echoed": "[Explanation]: echo\n\n" + RESPONSE_LETTERS,
          "nothing": "no assessment at all"}


@pytest.fixture(autouse=True)
def no_sentence_transformers(monkeypatch):
    """The JAX package's embedder takes TF-IDF, never a download."""
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)


def _responses():
    out = dict(INLINE)
    for name in FIXTURES:
        with open(os.path.join(FIXDIR, name)) as f:
            out[name] = f.read()
    return out


RESPONSES = _responses()


@pytest.mark.parametrize("name", list(RESPONSES))
def test_parsers_match_jax(name):
    raw = RESPONSES[name]
    assert t_green.clean_response(raw) == j_green.clean_response(raw)
    text = t_green.clean_response(raw)
    for cat in j_green.CATEGORIES:
        for for_reward in (False, True):
            assert (t_green.parse_error_counts(text, cat, for_reward)
                    == j_green.parse_error_counts(text, cat, for_reward))
        assert (t_green.parse_error_sentences(text, cat)
                == j_green.parse_error_sentences(text, cat))
    assert t_green.compute_green(text) == j_green.compute_green(text)
    assert (t_green.compute_error_count(text)
            == j_green.compute_error_count(text))


def test_fixture_bank_scores():
    """The port scores the fixture bank as recorded."""
    with open(os.path.join(FIXDIR, "expected_scores.json")) as f:
        expected = json.load(f)
    for name, exp in expected.items():
        text = t_green.clean_response(RESPONSES[name])
        assert t_green.compute_green(text) == pytest.approx(exp["green"])
    with pytest.raises(ValueError):
        t_green.parse_error_counts("x", "Not a category")


@pytest.mark.parametrize("ref,cand", [
    ("REF_TEXT_HERE", "CAND_TEXT_HERE"),
    (" ".join(f"w{i}" for i in range(400)), "x  y\nz"), ("", "")])
def test_prompt_matches_jax(ref, cand):
    assert (t_green.make_green_prompt(ref, cand)
            == j_green.make_green_prompt(ref, cand))
    assert t_green.CATEGORIES == j_green.CATEGORIES
    assert t_green.SUB_CATEGORIES == j_green.SUB_CATEGORIES


SENTENCE_SETS = {
    "effusion_mass_nodule": [
        "Pleural effusion on the left", " pleural effusion right side",
        "pleural effusion small", "left pleural effusion, moderate",
        "Mass in the liver", "liver mass seen", "nodule in lung apex",
        "Lung nodule"],
    "two_topics": ["fracture of rib 4", "rib fracture, old", "rib fracture",
                   "cardiomegaly", "Cardiomegaly noted"],
    "case_and_punctuation": ["A AA aaa; B-b", "aa aa AA", "b bb, bb?",
                             "CT: no change", "x"],
}


@pytest.mark.parametrize("name", list(SENTENCE_SETS))
def test_tfidf_matches_sklearn(name):
    from sklearn.feature_extraction.text import TfidfVectorizer

    sents = SENTENCE_SETS[name]
    ref = TfidfVectorizer().fit_transform(sents).toarray()
    out = t_green._tfidf_embed(sents)
    assert out.shape == ref.shape and out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_tfidf_empty_vocabulary_raises_like_sklearn():
    from sklearn.feature_extraction.text import TfidfVectorizer

    with pytest.raises(ValueError):
        TfidfVectorizer().fit_transform(["a", "b"])
    with pytest.raises(ValueError):
        t_green._tfidf_embed(["a", "b"])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_silhouette_matches_sklearn(k):
    from sklearn.metrics import silhouette_score

    x = t_green._tfidf_embed(SENTENCE_SETS["effusion_mass_nodule"])
    labels = t_green.kmeans(x, k)
    np.testing.assert_allclose(t_green.silhouette_score(x, labels),
                               silhouette_score(x, labels), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        t_green.silhouette_score(x, np.zeros(len(x), np.int64))


def _partition(labels):
    groups = {}
    for i, l in enumerate(labels):
        groups.setdefault(int(l), []).append(i)
    return sorted(groups.values())


def test_kmeans_partition_matches_sklearn():
    """Three well-separated blobs: the same partition as scikit-learn's
    KMeans(n_init=10, random_state=0), and the same from one seed twice."""
    from sklearn.cluster import KMeans

    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(6, 4) * 0.05 + c for c in
                        (np.zeros(4), np.full(4, 3.0), np.arange(4.0))])
    out = t_green.kmeans(x, 3)
    ref = KMeans(n_clusters=3, n_init=10, random_state=0).fit(x).labels_
    assert _partition(out) == _partition(ref)
    np.testing.assert_array_equal(t_green.kmeans(x, 3), out)


@pytest.mark.parametrize("name", ["effusion_mass_nodule", "two_topics"])
def test_largest_cluster_matches_jax(name):
    sents = SENTENCE_SETS[name]
    emb, rep = t_green.compute_largest_cluster(sents)
    emb_j, rep_j = j_green.compute_largest_cluster(sents)
    assert rep == rep_j
    np.testing.assert_allclose(emb, emb_j, rtol=0, atol=1e-12)
    assert t_green.compute_largest_cluster([]) == (None, [])
    assert t_green.compute_largest_cluster(["one"]) == (None, ["one"])


def test_scorer_with_stub_judge_matches_jax(capsys):
    """GreenScorer over a judge that returns the test responses: the same
    scores, mean, std, rows and summary (representative sentences
    included) as the JAX package's."""
    # each subcategory's error sentences fall into one largest cluster
    # (a tie of sizes would leave the choice to the labels' numbering)
    responses = [RESPONSE_LETTERS, RESPONSE_NO_ERRORS,
                 RESPONSE_NO_MATCH.replace("3. X; Y; Z",
                                           "1. Pleural effusion right")
                 .replace("2. P; Q", "1. Old rib fracture"),
                 RESPONSE_NUMBERS.replace("Pleural effusion; Mass",
                                          "Pleural effusion left")]
    judge = lambda prompts: responses[: len(prompts)]
    refs, hyps = ["r1", "r2", "r3", "r4"], ["h1", "h2", "h3", "h4"]
    out = t_green.GreenScorer(judge, judge_name="stub")(refs, hyps)
    ref = j_green.GreenScorer(judge, judge_name="stub")(refs, hyps)
    assert out.scores == ref.scores
    assert (out.mean, out.std) == (ref.mean, ref.std)
    assert out.rows == ref.rows
    assert out.summary == ref.summary
    assert "Seconds per example" in capsys.readouterr().out


def test_openai_batch_judge_against_mock_server():
    """The batch-file workflow (generate, upload, create, probe, fetch)
    against a local mock of the OpenAI batch API that returns the results
    reversed: responses come back in prompt order."""
    import http.server
    import threading

    store = {"files": {}, "batches": {}}

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path == "/v1/files":
                text = raw.split(b"\r\n\r\n", 2)[-1]
                fid = f"file_{len(store['files'])}"
                store["files"][fid] = text.rsplit(b"\r\n--", 1)[0]
                self._json({"id": fid, "purpose": "batch"})
            elif self.path == "/v1/batches":
                req = json.loads(raw)
                assert req["endpoint"] == "/v1/chat/completions"
                bid = f"batch_{len(store['batches'])}"
                rows = [json.loads(l) for l in
                        store["files"][req["input_file_id"]].splitlines()]
                out = []
                for row in reversed(rows):
                    n = int(row["custom_id"].split("_")[-1]) + 1
                    content = ("[Explanation]:\nok\n\n"
                               "[Clinically Significant Errors]:\n"
                               "(a) False report: 0.\n\n"
                               f"[Matched Findings]:\n{n}. f1\n")
                    out.append(json.dumps({
                        "custom_id": row["custom_id"],
                        "response": {"body": {"choices": [
                            {"message": {"content": content}}]}}}))
                ofid = f"file_out_{bid}"
                store["files"][ofid] = "\n".join(out).encode()
                store["batches"][bid] = {"id": bid, "status": "completed",
                                         "output_file_id": ofid}
                self._json(store["batches"][bid])
            else:
                self._json({"error": "not found"}, 404)

        def do_GET(self):
            if self.path.startswith("/v1/batches/"):
                self._json(store["batches"][self.path.rsplit("/", 1)[-1]])
            elif (self.path.startswith("/v1/files/")
                  and self.path.endswith("/content")):
                body = store["files"][self.path.split("/")[3]]
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json({"error": "not found"}, 404)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        judge = t_green.OpenAIBatchJudge(
            base_url=f"http://127.0.0.1:{srv.server_port}/v1",
            api_key="test", model="mock", poll_seconds=0.05)
        prompts = [t_green.make_green_prompt(f"ref {c}", f"hyp {c}")
                   for c in "abc"]
        responses = judge(prompts)
        assert len(responses) == 3
        for i, r in enumerate(responses):
            assert f"[Matched Findings]:\n{i + 1}." in r
        result = t_green.GreenScorer(judge, compute_summary_stats=False)(
            ["ref a", "ref b", "ref c"], ["a", "b", "c"])
        assert result.scores == [1.0, 1.0, 1.0]
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# TorchJudge
# ---------------------------------------------------------------------------

JUDGE_VOCAB = 1024
# a reference long enough that the judge prompts of one case share more
# than 256 whitespace tokens (the template before it holds ~170)
CASE_REF = " ".join(f"finding{i % 40} of region{i % 7}" for i in range(45))
CANDIDATES = ["the lungs are clear", "small left pleural effusion is seen",
              "normal heart size and clear lungs without effusion",
              "nodule in the right upper lobe", "no acute findings today"]


@pytest.fixture(scope="module")
def judge_model():
    from u2tokenizer_torch.config import LLMConfig
    from u2tokenizer_torch.models.layers import init_weights
    from u2tokenizer_torch.models.llm.decoder import CausalLM

    model = CausalLM(LLMConfig.tiny(vocab_size=JUDGE_VOCAB),
                     dtype=torch.float32, device="cpu")
    init_weights(model, 0)
    return model


def _judge(model, tok, **kw):
    kw = {"batch_size": 2, "max_length": 512, "max_new_tokens": 12,
          "device": "cpu", **kw}
    return t_green.TorchJudge(model, tok, **kw)


def _prompts(tok):
    from u2tokenizer_torch.eval.inference import green_chat_format

    prompts = [green_chat_format(t_green.make_green_prompt(CASE_REF, c))
               for c in CANDIDATES]
    for p in prompts:
        tok(p)
    assert len(tok.vocab) < JUDGE_VOCAB
    return prompts


def test_judge_batch_inputs():
    """Rows padded to max_length, the tail batch a power of two, and the
    shared prefix a multiple of 256 below the common prefix, leaving every
    row a token of its own."""
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    tok = MockTokenizer()
    prompts = _prompts(tok)
    model = type("Stub", (torch.nn.Module,), {})()
    model.w = torch.nn.Parameter(torch.zeros(1))
    judge = t_green.TorchJudge(model, tok, batch_size=4, max_length=512,
                               device="cpu")
    ids, lens, split = judge.batch_inputs(prompts[:4])
    enc = [tok(p)["input_ids"] for p in prompts[:4]]
    assert tuple(ids.shape) == (4, 512) and lens.tolist() == [len(e)
                                                              for e in enc]
    lcp = next(i for i in range(len(enc[0]))
               if len({tuple(e[:i + 1]) for e in enc}) > 1)
    assert split == lcp // 256 * 256 and 0 < split < min(map(len, enc))
    ids, lens, split = judge.batch_inputs(prompts[4:5])
    assert ids.shape[0] == 1 and split == 0
    assert [t_green.TorchJudge._tail_batch(r, 8) for r in (1, 3, 5, 8)] == \
        [1, 4, 8, 8]
    judge.share_prefix = False
    assert judge.batch_inputs(prompts[:4])[2] == 0


@pytest.mark.parametrize("speculative", [False, True])
@pytest.mark.parametrize("share_prefix", [False, True])
def test_judge_tokens_are_greedy_generate(judge_model, speculative,
                                          share_prefix):
    """Every route of TorchJudge gives the greedy tokens of
    make_generate_fn over the same padded batch (fp32 on the CPU: equal),
    and decodes them to its responses; five prompts at batch 2 leave a
    tail of one."""
    from u2tokenizer_torch.config import GenerationConfig
    from u2tokenizer_torch.models.generate import make_generate_fn
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    tok = MockTokenizer()
    prompts = _prompts(tok)
    judge = _judge(judge_model, tok, chat_format=False,
                   speculative=speculative, share_prefix=share_prefix)
    gen = make_generate_fn(judge_model, GenerationConfig(
        max_new_tokens=12, eos_token_id=tok.eos_token_id, pad_token_id=0))
    want = []
    for i in range(0, len(prompts), 2):
        ids, lens, split = judge.batch_inputs(prompts[i:i + 2])
        assert bool(split) == (share_prefix and ids.shape[0] > 1)
        toks = judge.batch_tokens(ids, lens, split)
        ref = gen(judge_model.embed_tokens(ids), lens)
        assert torch.equal(toks, ref)
        want += [tok.decode([t for t in row if t != 0])
                 for row in ref.tolist()[: len(prompts[i:i + 2])]]
    assert judge(prompts) == want


def test_judge_chat_format_and_scorer(judge_model):
    """The judge wraps prompts in the GREEN chat format by default and
    composes with GreenScorer (random weights: no parseable score)."""
    from u2tokenizer_torch.eval.inference import green_chat_format
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    tok = MockTokenizer()
    _prompts(tok)
    judge = _judge(judge_model, tok)
    plain = _judge(judge_model, tok, chat_format=False)
    raw = [t_green.make_green_prompt(CASE_REF, c) for c in CANDIDATES[:2]]
    assert judge(raw) == plain([green_chat_format(p) for p in raw])
    result = t_green.GreenScorer(judge, compute_summary_stats=False)(
        [CASE_REF] * 2, CANDIDATES[:2])
    assert len(result.scores) == 2 and len(result.rows) == 2


def test_judge_needs_its_device(judge_model, monkeypatch):
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    with pytest.raises(ValueError, match="parameters are on cpu"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        t_green.TorchJudge(judge_model, MockTokenizer())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_green.TorchJudge(judge_model, MockTokenizer())
