"""Data-synthesis clients: OpenAI-protocol / vLLM / ollama wrappers and the
report-rewrite / QA-generation / translation / thinking-refinement pipeline
(a copy of ``u2tokenizer_tpu/data/synthesis.py``; the port's own
``serve-llm`` is one such server).

Behavioral rebuild of the reference's L6 layer (SURVEY.md §2.6):
src/utils/vllm_func.py (rewrite/translate/QA prompts with retry-on-ratelimit),
src/utils/ollama_func.py, src/preprocess/qwen3_data_synthesis.py (sync/async
OpenAI-protocol calls, <think> extraction), and the staged
thinking_refine_and_vqa_filter.py pipeline. All network use is optional and
gated: the operations accept any callable backend (e.g. a local judge's
generator) in place of an HTTP server.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from .prompt_templates import qa_generation_prompt, rewrite_prompt, translate_prompt

THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)


def split_thinking(text: str):
    """Extract '<think>...</think>' reasoning from a completion
    (qwen3_data_synthesis.py thinking-mode parsing). Returns
    (thinking or None, answer)."""
    m = THINK_RE.search(text)
    if not m:
        return None, text.strip()
    answer = THINK_RE.sub("", text, count=1).strip()
    return m.group(1).strip(), answer


@dataclass
class LLMClientConfig:
    base_url: str = "http://localhost:8088/v1"
    api_key: str = "EMPTY"
    model: str = "Qwen/Qwen3-8B"
    temperature: float = 0.7
    top_p: float = 0.8
    max_tokens: int = 2048
    enable_thinking: bool = False
    max_retries: int = 5
    retry_backoff: float = 2.0


class OpenAIProtocolClient:
    """Minimal chat-completions client with retry/backoff
    (vllm_func.py:22-100 behavior). Talks to any OpenAI-protocol server
    (vLLM, ollama's compat endpoint, OpenAI itself)."""

    def __init__(self, cfg: LLMClientConfig):
        self.cfg = cfg

    def complete(self, prompt: str, system: Optional[str] = None) -> str:
        import urllib.error
        import urllib.request

        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        body = {
            "model": self.cfg.model,
            "messages": messages,
            "temperature": self.cfg.temperature,
            "top_p": self.cfg.top_p,
            "max_tokens": self.cfg.max_tokens,
        }
        if not self.cfg.enable_thinking:
            body["chat_template_kwargs"] = {"enable_thinking": False}
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"{self.cfg.base_url}/chat/completions", data=data,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.cfg.api_key}"})
        delay = 1.0
        for attempt in range(self.cfg.max_retries):
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    out = json.loads(resp.read())
                return out["choices"][0]["message"]["content"]
            except urllib.error.HTTPError as e:
                if e.code in (429, 500, 503) and attempt + 1 < self.cfg.max_retries:
                    time.sleep(delay)
                    delay *= self.cfg.retry_backoff
                    continue
                raise
        raise RuntimeError("unreachable")

    def __call__(self, prompt: str, system: Optional[str] = None) -> str:
        return self.complete(prompt, system)


Backend = Callable[[str], str]  # prompt -> completion


# ---------------------------------------------------------------------------
# synthesis operations (vllm_func.py prompts)
# ---------------------------------------------------------------------------

def rewrite_report(backend: Backend, report: str) -> str:
    """CT-report paraphrase (vllm_func.py rewrite path; prompt bank
    prompt_templates.rewrite_prompt)."""
    _, answer = split_thinking(backend(f"{rewrite_prompt}\n\nReport:\n{report}"))
    return answer


def translate_report(backend: Backend, report: str) -> str:
    _, answer = split_thinking(backend(f"{translate_prompt}\n\n{report}"))
    return answer


def generate_qa_pairs(backend: Backend, report: str, n: int = 3) -> List[dict]:
    """Report -> n question/answer pairs as JSON (vllm_func.py QA-gen)."""
    prompt = qa_generation_prompt.format(n=n) + "\n\nReport:\n" + report
    _, answer = split_thinking(backend(prompt))
    # models often wrap JSON in fences; extract the first JSON array
    m = re.search(r"\[.*\]", answer, re.DOTALL)
    if not m:
        return []
    try:
        pairs = json.loads(m.group(0))
    except json.JSONDecodeError:
        return []
    return [p for p in pairs
            if isinstance(p, dict) and "question" in p and "answer" in p]


# ---------------------------------------------------------------------------
# thinking refine + VQA filter pipeline (thinking_refine_and_vqa_filter.py)
# ---------------------------------------------------------------------------

FILTER_PROMPT = (
    "You are reviewing a VQA pair generated from a CT report. Answer YES if "
    "the question is answerable from the report and the answer is correct "
    "and clinically meaningful; otherwise answer NO. Reply with only YES or "
    "NO.\n\nReport:\n{report}\n\nQuestion: {question}\nAnswer: {answer}"
)

REFINE_PROMPT = (
    "Rewrite the reasoning below into a concise clinical chain of thought "
    "that justifies the answer from the report evidence, then restate the "
    "answer. Format:\n<think>reasoning</think>\nanswer\n\nReport:\n{report}\n"
    "Question: {question}\nDraft reasoning: {thinking}\nAnswer: {answer}"
)


def filter_vqa_pair(backend: Backend, report: str, question: str,
                    answer: str) -> bool:
    _, verdict = split_thinking(
        backend(FILTER_PROMPT.format(report=report, question=question,
                                     answer=answer)))
    return verdict.strip().upper().startswith("YES")


def refine_thinking(backend: Backend, report: str, question: str,
                    thinking: str, answer: str):
    """-> (refined_thinking, refined_answer)."""
    out = backend(REFINE_PROMPT.format(report=report, question=question,
                                       thinking=thinking, answer=answer))
    return split_thinking(out)


def synthesize_dataset(
    backend: Backend,
    rows: Sequence[dict],
    *,
    ops: Sequence[str] = ("rewrite",),
    qa_per_report: int = 3,
    progress: bool = False,
) -> List[dict]:
    """Batch loop: per input {image, question, answer[, report]} row, apply
    the requested ops and emit training jsonl rows (the per-dataset
    converters' shared core, src/preprocess/{amos_mm,ct_rate,...})."""
    out: List[dict] = []
    for i, row in enumerate(rows):
        report = row.get("report", row.get("answer", ""))
        try:
            if "rewrite" in ops:
                new = dict(row)
                new["answer"] = rewrite_report(backend, report)
                out.append(new)
            if "translate" in ops:
                new = dict(row)
                new["answer"] = translate_report(backend, report)
                out.append(new)
            if "qa" in ops:
                for pair in generate_qa_pairs(backend, report, qa_per_report):
                    out.append({"image": row.get("image"),
                                "question": pair["question"],
                                "answer": pair["answer"]})
        except Exception as e:  # keep the batch going (reference logs+skips)
            print(f"synthesis error on row {i}: {e}")
        if progress and (i + 1) % 50 == 0:
            print(f"synthesized {i + 1}/{len(rows)}")
    return out


# ---------------------------------------------------------------------------
# jsonl utilities (src/preprocess/json2jsonl.py, merge_jsonl.py)
# ---------------------------------------------------------------------------

def json_to_jsonl(json_path: str, jsonl_path: str, key: Optional[str] = None):
    with open(json_path) as f:
        data = json.load(f)
    if key is not None:
        data = data[key]
    with open(jsonl_path, "w") as f:
        for row in data:
            f.write(json.dumps(row) + "\n")


def merge_jsonl(paths: Sequence[str], out_path: str):
    with open(out_path, "w") as out:
        for p in paths:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.write(line + "\n")
