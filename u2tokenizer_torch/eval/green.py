"""GREEN scorer: LLM-as-judge report evaluation (counterpart of
``u2tokenizer_tpu/eval/green.py``).

The reference's green_refactored/green.py:200-460, as the JAX package
rebuilt it:

  * ``make_green_prompt``, the judge prompt (utils.py:318-332), whose
    output-format section is a contract with the parsers;
  * ``parse_error_counts``, per-category error counts from the (a)-(f) and
    (1)-(6) judge output variants and "No ..." responses
    (green.py:326-366);
  * ``compute_green``: matched / (matched + the significant errors), 0
    when nothing matched (green.py:314-324);
  * summary statistics: per-subcategory accuracy and representative error
    sentences, the largest cluster of a k-means over TF-IDF sentence
    embeddings whose k the silhouette score picks (green.py:412-460).
    TF-IDF, k-means and the silhouette are computed here with torch
    (sklearn's defaults: lowercase, tokens of two or more word
    characters, smoothed idf, l2 rows; k-means++ with 10 seeded starts);
    the JAX package calls
    scikit-learn, or the reference's sentence-transformers checkpoint when
    it is installed, which the port never downloads. Scores do not depend
    on them; only the representative sentences do.

The judge is any ``complete(prompts) -> responses`` callable:
``TorchJudge`` runs a decoder (an HF checkpoint such as GREEN-RadLlama2
converted by ``models.hf_weights``) on the port's own generate loops,
``OpenAIBatchJudge`` a hosted judge over the OpenAI batch-file protocol.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CATEGORIES = (
    "Clinically Significant Errors",
    "Clinically Insignificant Errors",
    "Matched Findings",
)

SUB_CATEGORIES = (
    "(a) False report of a finding in the candidate",
    "(b) Missing a finding present in the reference",
    "(c) Misidentification of a finding's anatomic location/position",
    "(d) Misassessment of the severity of a finding",
    "(e) Mentioning a comparison that isn't in the reference",
    "(f) Omitting a comparison detailing a change from a prior study",
)


def make_green_prompt(reference: str, candidate: str, max_len: int = 300) -> str:
    """The GREEN judge prompt (utils.py:318-332). The exact output-format
    section is a contract with ``parse_error_counts``."""
    reference = " ".join(reference.split()[:max_len])
    candidate = " ".join(candidate.split()[:max_len])
    return (
        "Objective: Evaluate the accuracy of a candidate radiology report in "
        "comparison to a reference radiology report composed by expert "
        "radiologists.\n\n    Process Overview: You will be presented with:\n\n"
        "    1. The criteria for making a judgment.\n"
        "    2. The reference radiology report.\n"
        "    3. The candidate radiology report.\n"
        "    4. The desired format for your assessment.\n\n"
        "    1. Criteria for Judgment:\n\n    For each candidate report, "
        "determine:\n\n    The count of clinically significant errors.\n"
        "    The count of clinically insignificant errors.\n\n"
        "    Errors can fall into one of these categories:\n\n"
        "    a) False report of a finding in the candidate.\n"
        "    b) Missing a finding present in the reference.\n"
        "    c) Misidentification of a finding's anatomic location/position.\n"
        "    d) Misassessment of the severity of a finding.\n"
        "    e) Mentioning a comparison that isn't in the reference.\n"
        "    f) Omitting a comparison detailing a change from a prior study.\n"
        "    Note: Concentrate on the clinical findings rather than the "
        "report's writing style. Evaluate only the findings that appear in "
        "both reports.\n\n"
        f"    2. Reference Report:\n    {reference}\n\n"
        f"    3. Candidate Report:\n    {candidate}\n\n"
        "    4. Reporting Your Assessment:\n\n"
        "    Follow this specific format for your output, even if no errors "
        "are found:\n    ```\n    [Explanation]:\n    <Explanation>\n\n"
        "    [Clinically Significant Errors]:\n"
        "    (a) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n    ....\n"
        "    (f) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n\n"
        "    [Clinically Insignificant Errors]:\n"
        "    (a) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n    ....\n"
        "    (f) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; "
        "...; <Error n>\n\n"
        "    [Matched Findings]:\n"
        "    <The number of matched findings>. <Finding 1>; <Finding 2>; ...; "
        "<Finding n>\n    ```\n"
    )


def clean_response(response: str) -> str:
    """Strip everything before the final assessment block (the judge may echo
    the prompt); keep from the last '[Explanation]:' on
    (utils.py clean_responses behavior)."""
    marker = "[Explanation]:"
    if response.count(marker) > 1:
        response = response[response.rindex(marker):]
    for fence in ("```", "<|im_end|>", "</s>"):
        response = response.replace(fence, "")
    return response.strip()


def parse_error_counts(text: str, category: str,
                       for_reward: bool = False) -> Tuple[Optional[int], Optional[List[int]]]:
    """(sum, per-subcategory counts) for one category (green.py:326-366)."""
    if category not in CATEGORIES:
        raise ValueError(f"Category {category} is not valid: {CATEGORIES}")

    pattern = rf"\[{category}\]:\s*(.*?)(?:\n\s*\n|\Z)"
    m = re.search(pattern, text, re.DOTALL)

    sum_counts = 0
    sub_counts = [0] * 6
    if not m:
        if for_reward:
            return None, None
        return sum_counts, sub_counts
    body = m.group(1)
    if body.startswith("No"):
        return sum_counts, sub_counts

    if category == "Matched Findings":
        counts = re.findall(r"^\b\d+\b(?=\.)", body)
        if counts:
            sum_counts = int(counts[0])
        return sum_counts, sub_counts

    labels = [s.split(" ", 1)[0] + " " for s in SUB_CATEGORIES]
    matches = sorted(re.findall(r"\([a-f]\) .*", body))
    if not matches:
        matches = sorted(re.findall(r"\([1-6]\) .*", body))
        labels = [f"({i}) " for i in range(1, 7)]
    for pos, label in enumerate(labels):
        for match in matches:
            if match.startswith(label):
                count = re.findall(r"(?<=: )\b\d+\b(?=\.)", match)
                if count:
                    sub_counts[pos] = int(count[0])
    return sum(sub_counts), sub_counts


def parse_error_sentences(response: str, category: str) -> Dict[str, List[str]]:
    """Per-subcategory error sentences (green.py:368-407)."""
    pattern = rf"\[{category}\]:\s*(.*?)(?:\n\s*\n|\Z)"
    m = re.search(pattern, response, re.DOTALL)
    out: Dict[str, List[str]] = {s: [] for s in SUB_CATEGORIES}
    if not m or m.group(1).startswith("No"):
        return out
    body = m.group(1)
    labels = [s.split(" ", 1)[0] + " " for s in SUB_CATEGORIES]
    matches = sorted(re.findall(r"\([a-f]\) .*", body))
    if not matches:
        matches = sorted(re.findall(r"\([1-6]\) .*", body))
        labels = [f"({i}) " for i in range(1, 7)]
    for pos, label in enumerate(labels):
        for match in matches:
            if match.startswith(label):
                out[SUB_CATEGORIES[pos]] = (
                    match.rsplit(":", 1)[-1].split(".", 1)[-1].split(";"))
    return out


def compute_green(response: str) -> Optional[float]:
    """matched / (matched + Σ significant); 0 if no matched findings."""
    sig_present, sig_errors = parse_error_counts(response, CATEGORIES[0])
    matched, _ = parse_error_counts(response, CATEGORIES[2])
    if matched == 0:
        return 0.0
    if sig_present is None or matched is None:
        return None
    return matched / (matched + sum(sig_errors))


def compute_error_count(response: str) -> List[int]:
    _, sig = parse_error_counts(response, CATEGORIES[0])
    matched, _ = parse_error_counts(response, CATEGORIES[2])
    return list(sig) + [matched]


# ---------------------------------------------------------------------------
# representative-sentence clustering (green.py:412-430, utils.py:133-180)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"(?u)\b\w\w+\b")


def _tfidf_embed(sentences: List[str]) -> np.ndarray:
    """(n, vocabulary) float64 TF-IDF rows as scikit-learn's
    ``TfidfVectorizer().fit_transform(sentences).toarray()`` gives them:
    lowercased word tokens of two or more characters, columns in sorted
    vocabulary order, raw counts times idf = ln((1 + n) / (1 + df)) + 1,
    each row scaled to unit l2 norm (an empty row stays zero). Raises
    ValueError on an empty vocabulary, as scikit-learn does."""
    docs = [Counter(_TOKEN.findall(s.lower())) for s in sentences]
    vocab = sorted(set().union(*docs))
    if not vocab:
        raise ValueError("empty vocabulary; perhaps the documents only "
                         "contain stop words")
    col = {w: j for j, w in enumerate(vocab)}
    tf = torch.zeros(len(docs), len(vocab), dtype=torch.float64)
    for i, doc in enumerate(docs):
        for w, c in doc.items():
            tf[i, col[w]] = c
    df = (tf > 0).sum(0).double()
    idf = torch.log((1.0 + len(docs)) / (1.0 + df)) + 1.0
    x = tf * idf
    norm = x.norm(dim=1, keepdim=True)
    return torch.where(norm > 0, x / norm.clamp(min=1e-300), x).numpy()


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)


def kmeans(x: np.ndarray, k: int, n_init: int = 10, seed: int = 0,
           max_iter: int = 300, tol: float = 1e-4) -> np.ndarray:
    """Labels (n,) of the lowest-inertia run of ``n_init`` Lloyd k-means
    runs from greedy k-means++ starts (2 + ln k trials a centre, as
    scikit-learn's), drawn from a torch generator seeded by ``seed``. An
    empty cluster takes the point farthest from its centre."""
    x = torch.as_tensor(x, dtype=torch.float64)
    n = x.shape[0]
    g = torch.Generator().manual_seed(seed)
    trials = 2 + int(np.log(k))
    # scikit-learn's tolerance: tol times the mean variance of the features
    tol = tol * x.var(dim=0, unbiased=False).mean().item()
    best, best_inertia = None, float("inf")
    for _ in range(n_init):
        centres = [x[int(torch.randint(n, (), generator=g))]]
        closest = _sq_dists(x, centres[0][None])[:, 0]
        for _ in range(1, k):
            total = closest.sum().item()
            if total <= 0:  # every point sits on a centre already
                cand = torch.randint(n, (trials,), generator=g)
            else:
                u = torch.rand(trials, generator=g, dtype=torch.float64)
                cand = torch.searchsorted(closest.cumsum(0), u * total)
                cand = cand.clamp(max=n - 1)
            d = torch.minimum(closest[None], _sq_dists(x, x[cand]).t())
            pick = int(d.sum(1).argmin())
            centres.append(x[cand[pick]])
            closest = d[pick]
        c = torch.stack(centres)
        for _ in range(max_iter):
            labels = _sq_dists(x, c).argmin(1)
            new = c.clone()
            for j in range(k):
                members = x[labels == j]
                if len(members):
                    new[j] = members.mean(0)
                else:
                    far = _sq_dists(x, c).min(1).values.argmax()
                    new[j] = x[far]
            shift = ((new - c) ** 2).sum().item()
            c = new
            if shift <= tol:
                break
        d = _sq_dists(x, c)
        labels = d.argmin(1)
        inertia = d.min(1).values.sum().item()
        if inertia < best_inertia:
            best, best_inertia = labels, inertia
    return best.numpy()


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette over samples, Euclidean (scikit-learn's
    ``silhouette_score``): (b - a) / max(a, b), 0 for a sample alone in its
    cluster. Raises ValueError unless 2 <= clusters <= n - 1."""
    x = torch.as_tensor(x, dtype=torch.float64)
    labels = torch.as_tensor(labels)
    ids = labels.unique()
    n = x.shape[0]
    if not 2 <= len(ids) <= n - 1:
        raise ValueError(f"Number of labels is {len(ids)}. Valid values are "
                         "2 to n_samples - 1 (inclusive)")
    d = torch.cdist(x, x)
    member = labels[:, None] == ids[None, :]          # (n, k)
    size = member.sum(0).double()
    sums = d @ member.double()                        # (n, k)
    own = member.double().argmax(1)
    rows = torch.arange(n)
    own_size = size[own]
    a = sums[rows, own] / (own_size - 1).clamp(min=1)
    mean_other = sums / size[None]
    mean_other[rows, own] = float("inf")
    b = mean_other.min(1).values
    s = (b - a) / torch.maximum(a, b)
    s = torch.where(own_size > 1, torch.nan_to_num(s), torch.zeros_like(s))
    return float(s.mean())


def compute_largest_cluster(sentences: List[str]):
    """k-means with silhouette-selected k; returns (embeddings, sentences of
    the largest cluster)."""
    if len(sentences) == 0:
        return None, []
    if len(sentences) == 1:
        return None, sentences
    emb = _tfidf_embed(sentences)
    best_k, best_score, best_labels = 2, -1.0, None
    for k in range(2, min(len(sentences), 9)):
        labels = kmeans(emb, k, n_init=10, seed=0)
        if len(set(labels.tolist())) < 2:
            continue
        try:
            score = silhouette_score(emb, labels)
        except ValueError:
            continue
        if score > best_score:
            best_k, best_score, best_labels = k, score, labels
    if best_labels is None:
        return emb, sentences
    counts = np.bincount(best_labels)
    largest = int(np.argmax(counts))
    return emb, [s for s, l in zip(sentences, best_labels) if l == largest]


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------

@dataclass
class GreenResult:
    mean: float
    std: float
    scores: List[Optional[float]]
    summary: str
    rows: List[dict] = field(default_factory=list)


class GreenScorer:
    """GREEN(refs, hyps) — judge, parse, score, summarize."""

    def __init__(self, judge: Callable[[Sequence[str]], Sequence[str]],
                 compute_summary_stats: bool = True,
                 judge_name: str = "judge"):
        self.judge = judge
        self.compute_summary_stats = compute_summary_stats
        self.judge_name = judge_name

    def __call__(self, refs: Sequence[str], hyps: Sequence[str]) -> GreenResult:
        import time

        t0 = time.time()
        prompts = [make_green_prompt(r, h) for r, h in zip(refs, hyps)]
        responses = [clean_response(r) for r in self.judge(prompts)]
        scores = [compute_green(r) for r in responses]
        valid = [s for s in scores if s is not None]
        mean = float(np.mean(valid)) if valid else 0.0
        std = float(np.std(valid)) if valid else 0.0

        rows = [{"reference": r, "prediction": h, "response": resp,
                 "green": s, "error_counts": compute_error_count(resp)}
                for r, h, resp, s in zip(refs, hyps, responses, scores)]

        summary = ""
        if self.compute_summary_stats:
            summary = self._summary(responses, mean, std)
        print(f"Seconds per example: {(time.time() - t0) / max(len(refs), 1)}")
        return GreenResult(mean, std, scores, summary, rows)

    def _summary(self, responses: List[str], mean: float, std: float) -> str:
        counts = np.array([
            parse_error_counts(r, CATEGORIES[0])[1] for r in responses])
        sentences_per_sub: Dict[str, List[str]] = {s: [] for s in SUB_CATEGORIES}
        for r in responses:
            for sub, sents in parse_error_sentences(r, CATEGORIES[0]).items():
                sentences_per_sub[sub].extend(
                    s for s in sents if s.strip())
        summary = (
            f"\n-------------{self.judge_name}----------------\n"
            f" [Summary]: Green average {mean} and standard deviation {std} \n"
            " [Clinically Significant Errors Analyses]: <accuracy>. "
            "<representative error>\n\n")
        for i, sub in enumerate(SUB_CATEGORIES):
            accuracy = float(np.mean(counts[:, i] == 0)) if len(counts) else 1.0
            _, rep = compute_largest_cluster(sentences_per_sub[sub])
            summary += f"{sub}: {accuracy}. \n {rep} \n\n"
        summary += "----------------------------------\n"
        return summary


class OpenAIBatchJudge:
    """GREEN judge over the OpenAI *batch-file* API — the cheap hosted
    judging path (half-price, 24 h window). Behavioral rebuild of
    green_refactored/green.py:148-186 (generate_batch_file / upload /
    run_batch / probe_batch / fetch_batch_result) on stdlib urllib, so it
    works against OpenAI or any protocol-compatible server with no client
    dependency.

    Callable like every other judge: ``judge(prompts) -> responses``
    (submits one batch, polls until completion). The step methods are
    public for the fire-and-forget workflow (submit today, fetch
    tomorrow)."""

    def __init__(self, base_url: str = "https://api.openai.com/v1",
                 api_key: str = "", model: str = "gpt-4o-mini",
                 max_tokens: int = 6000, poll_seconds: float = 30.0,
                 timeout_seconds: float = 24 * 3600.0):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.max_tokens = max_tokens
        self.poll_seconds = poll_seconds
        self.timeout_seconds = timeout_seconds

    # -- request plumbing ------------------------------------------------

    def _request(self, path: str, data: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> dict:
        import json as _json
        import urllib.request

        hdr = {"Authorization": f"Bearer {self.api_key}"}
        if data is not None and (headers is None or
                                 "Content-Type" not in headers):
            hdr["Content-Type"] = "application/json"
        hdr.update(headers or {})
        req = urllib.request.Request(f"{self.base_url}{path}", data=data,
                                     headers=hdr)
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = resp.read()
        return _json.loads(body)

    # -- batch-file workflow (green.py:148-186 step parity) --------------

    def generate_batch_file(self, prompts: Sequence[str],
                            file_name: str) -> None:
        """One /v1/chat/completions request per prompt, custom_id green_<i>."""
        import json as _json

        with open(file_name, "w") as f:
            for i, prompt in enumerate(prompts):
                request = {
                    "custom_id": f"green_{i}",
                    "method": "POST",
                    "url": "/v1/chat/completions",
                    "body": {
                        "model": self.model,
                        "messages": [{"role": "user", "content": prompt}],
                        "max_tokens": self.max_tokens,
                    },
                }
                f.write(_json.dumps(request) + "\n")

    def upload_batch_file(self, file_name: str) -> str:
        """multipart/form-data upload with purpose=batch; returns file id."""
        import os as _os
        import uuid

        boundary = uuid.uuid4().hex
        with open(file_name, "rb") as f:
            content = f.read()
        part = (
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="purpose"\r\n\r\n'
            "batch\r\n"
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="file"; '
            f'filename="{_os.path.basename(file_name)}"\r\n'
            "Content-Type: application/jsonl\r\n\r\n"
        ).encode() + content + f"\r\n--{boundary}--\r\n".encode()
        out = self._request(
            "/files", data=part,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        return out["id"]

    def run_batch(self, batch_file_id: str) -> str:
        import json as _json

        out = self._request("/batches", data=_json.dumps({
            "input_file_id": batch_file_id,
            "endpoint": "/v1/chat/completions",
            "completion_window": "24h",
        }).encode())
        return out["id"]

    def probe_batch(self, batch_id: str) -> str:
        return self._request(f"/batches/{batch_id}")["status"]

    def fetch_batch_result(self, batch_id: str) -> Optional[List[str]]:
        """None until completed; then responses ordered by custom_id index
        (the batch API does not guarantee output order)."""
        import json as _json
        import urllib.request

        status = self._request(f"/batches/{batch_id}")
        if status["status"] != "completed":
            return None
        req = urllib.request.Request(
            f"{self.base_url}/files/{status['output_file_id']}/content",
            headers={"Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            content = resp.read()
        by_index: Dict[int, str] = {}
        for line in content.splitlines():
            if not line.strip():
                continue
            row = _json.loads(line)
            idx = int(str(row["custom_id"]).rsplit("_", 1)[-1])
            by_index[idx] = (
                row["response"]["body"]["choices"][0]["message"]["content"])
        return [by_index.get(i, "") for i in range(max(by_index) + 1)] \
            if by_index else []

    # -- synchronous judge interface -------------------------------------

    def __call__(self, prompts: Sequence[str]) -> List[str]:
        import tempfile
        import time as _time

        with tempfile.NamedTemporaryFile("w", suffix=".jsonl",
                                         delete=False) as f:
            file_name = f.name
        self.generate_batch_file(prompts, file_name)
        batch_id = self.run_batch(self.upload_batch_file(file_name))
        deadline = _time.time() + self.timeout_seconds
        while _time.time() < deadline:
            result = self.fetch_batch_result(batch_id)
            if result is not None:
                return result
            status = self.probe_batch(batch_id)
            if status in ("failed", "expired", "cancelled"):
                raise RuntimeError(f"batch {batch_id} ended: {status}")
            _time.sleep(self.poll_seconds)
        raise TimeoutError(f"batch {batch_id} not complete after "
                           f"{self.timeout_seconds}s")


class TorchJudge:
    """Judge backend on the port's decoder (text-only greedy generate),
    batched (reference batch_size=4, green.py:211), on ``device`` (the GPU
    unless the caller names another; the model must lie there).

    Each batch's prompts are right-padded to ``max_length`` (2048). The
    judge's output quotes sentences of the two reports in its prompt, so
    by default it decodes speculatively with n-gram drafts
    (``models.speculative``, the same tokens as plain greedy up to bf16
    near ties). pred_then_green scores 8 candidates against one reference
    a case (pred_then_green.py:105-137), so the judge prompts of a batch
    share [chat head ; GREEN template ; reference]: ``share_prefix``
    prefills their longest common token prefix once, cut down to a
    multiple of 256 tokens and leaving every row one token of its own. A
    last partial batch runs at the smallest power of two that holds it.
    ``batch_inputs`` and ``batch_tokens`` are the two halves of a batch,
    for checks that hold one route's tokens against another's."""

    def __init__(self, model, tokenizer, batch_size: int = 4,
                 max_length: int = 2048, max_new_tokens: int = 600,
                 chat_format: bool = True, speculative: bool = True,
                 share_prefix: bool = True, device="cuda"):
        from ..config import GenerationConfig
        from ..models.u2_model import resolve_model_device

        self.device = resolve_model_device(model, device)
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=False,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id or 0)
        self.chat_format = chat_format
        self.speculative = speculative
        self.share_prefix = share_prefix
        self._gen_cache = {}

    def _gen_for(self, n: int, split: int):
        """The generate fn for a batch whose n rows share their first
        ``split`` prompt tokens (split 0: the plain one-shot prefill)."""
        key = (n, split)
        if key not in self._gen_cache:
            from ..models.generate import make_generate_fn
            from ..models.speculative import make_spec_generate_fn

            sp = (n, split) if split else None
            make = make_spec_generate_fn if self.speculative \
                else make_generate_fn
            self._gen_cache[key] = make(self.model, self.gen_cfg,
                                        shared_prefix=sp)
        return self._gen_cache[key]

    @staticmethod
    def _tail_batch(remainder: int, bs: int) -> int:
        """The batch size of a final partial chunk: the smallest power of
        two >= remainder, capped at bs."""
        size = 1
        while size < remainder:
            size *= 2
        return min(size, bs)

    def batch_inputs(self, chunk: Sequence[str]):
        """(ids (run_bs, max_length) int64, lens (run_bs,) int32, split) on
        the device for one batch of formatted prompts: padded to the run
        batch with copies of its last prompt, and the shared prefix split
        (0 when off)."""
        bs = self.batch_size
        chunk = list(chunk)
        run_bs = bs if len(chunk) == bs else self._tail_batch(len(chunk), bs)
        chunk += [chunk[-1]] * (run_bs - len(chunk))
        enc = [self.tokenizer(p)["input_ids"][: self.max_length]
               for p in chunk]
        ids = np.full((run_bs, self.max_length), self.gen_cfg.pad_token_id,
                      np.int64)
        lens = np.zeros((run_bs,), np.int32)
        for j, e in enumerate(enc):
            ids[j, : len(e)] = e
            lens[j] = len(e)
        split = 0
        if self.share_prefix and run_bs > 1:
            # the batch's longest common token prefix, in 256-token
            # multiples, leaving every row >= 1 token of its own
            width = int(lens.min())
            same = (ids[:, :width] == ids[0:1, :width]).all(axis=0)
            lcp = width if same.all() else int(np.argmin(same))
            # max(..., 0): a row of no tokens gives width 0
            split = max((min(lcp, width - 1) // 256) * 256, 0)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(lens).to(self.device), split)

    @torch.no_grad()
    def batch_tokens(self, ids, lens, split: int) -> torch.Tensor:
        """(run_bs, max_new_tokens) greedy tokens of one batch."""
        gen_fn = self._gen_for(ids.shape[0], split)
        embeds = self.model.embed_tokens(ids)
        if self.speculative:
            return gen_fn(embeds, ids, lens)
        return gen_fn(embeds, lens)

    def __call__(self, prompts: Sequence[str]) -> List[str]:
        out: List[str] = []
        bs = self.batch_size
        if self.chat_format:
            from .inference import green_chat_format

            eos = getattr(self.tokenizer, "eos_token", "</s>") or "</s>"
            prompts = [green_chat_format(p, eos) for p in prompts]
        for i in range(0, len(prompts), bs):
            chunk = prompts[i:i + bs]
            toks = self.batch_tokens(*self.batch_inputs(chunk)).tolist()
            for row in toks[: len(chunk)]:
                out.append(self.tokenizer.decode(
                    [t for t in row if t != self.gen_cfg.pad_token_id],
                    skip_special_tokens=True))
        return out
