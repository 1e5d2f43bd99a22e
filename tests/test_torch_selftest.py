"""``cli selftest``, the crash reports and the profiling helpers of the
port against the JAX package, on the CPU: the selftest's artifacts have
the JAX commands' schema and row counts (its ``green`` and ``dpo-convert``
files equal the JAX commands' output on the same predictions, byte for
byte); ``record``'s report has JAX's keys plus the torch device fields;
``run_with_restarts``, ``is_transient``, ``StepTimer`` and
``param_count_report`` give what JAX's give on the same inputs (exactly:
they are integer counts, booleans, and float64 summaries of the same
times); ``trace`` writes a Chrome trace."""

import argparse
import json
import os
import sys
import tempfile
import time

import pytest
import torch

from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.config import U2ModelConfig
from u2tokenizer_torch.models.u2_model import U2CausalLM
from u2tokenizer_torch.utils import errors as t_err
from u2tokenizer_torch.utils import profiling as t_prof
from u2tokenizer_torch.weights import flax_params
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu.utils import errors as j_err
from u2tokenizer_tpu.utils import profiling as j_prof

pytestmark = pytest.mark.fast

ARTIFACTS = ("preds.jsonl", "greened.jsonl", "dpo.jsonl")


@pytest.fixture(autouse=True)
def no_sentence_transformers(monkeypatch):
    """The GREEN summary embeds with TF-IDF, never a download."""
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_selftest_runs_and_matches_jax_artifacts(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    work = t_cli.main(["selftest", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-2:] == [f"selftest artifacts in {work}", "SELFTEST OK"]
    assert os.path.dirname(work) == str(tmp_path)
    assert os.path.isdir(os.path.join(work, "out", "checkpoints", "2"))
    preds, greened, pairs = (_rows(os.path.join(work, f)) for f in ARTIFACTS)
    # two cases, greedy twins: each case's two samples are the same text
    assert [sorted(r) for r in preds] == [
        ["answer", "image", "predictions", "question"]] * 2
    assert all(len(r["predictions"]) == 2
               and r["predictions"][0] == r["predictions"][1]
               for r in preds)
    assert all(r["green_scores"] == [1.0, 1.0] for r in greened)
    assert len(pairs) == 2
    # the JAX commands on the same predictions write the same files
    j_green, j_pairs = str(tmp_path / "jg.jsonl"), str(tmp_path / "jp.jsonl")
    j_cli.cmd_green(argparse.Namespace(
        predictions=os.path.join(work, "preds.jsonl"), judge=None,
        no_summary=True, output=j_green))
    j_cli.cmd_dpo_convert(argparse.Namespace(greened=j_green,
                                             output=j_pairs))
    for mine, theirs in (("greened.jsonl", j_green), ("dpo.jsonl", j_pairs)):
        assert open(os.path.join(work, mine)).read() == open(theirs).read()


def test_selftest_needs_a_gpu_unless_told(monkeypatch, tmp_path):
    """Without a card the command raises, and ``main`` leaves its crash
    report in ./error_reports."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["selftest"])
    (name,) = os.listdir(tmp_path / "error_reports")
    with open(tmp_path / "error_reports" / name) as f:
        report = json.load(f)
    assert (report["exception_type"], report["backend"]) == ("RuntimeError",
                                                            "cpu")


def _report(mod, tmp_path, exc):
    def fail():
        raise exc

    with pytest.raises(type(exc)):
        mod.record(fail, error_dir=str(tmp_path))()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        return json.load(f)


def test_record_report_keys(tmp_path):
    exc = ValueError("bad input")
    mine = _report(t_err, tmp_path / "t", exc)
    theirs = _report(j_err, tmp_path / "j", exc)
    assert set(theirs) <= set(mine)
    for key in ("exception_type", "message", "argv", "host", "pid"):
        assert mine[key] == theirs[key]
    assert "ValueError: bad input" in mine["traceback"]
    assert (mine["backend"], mine["process_index"],
            mine["process_count"]) == ("cpu", 0, 1)


def test_record_report_names_the_card(tmp_path, monkeypatch):
    """With a card visible the report carries its name and its allocated
    and peak bytes (the CUDA calls stand in here)."""
    cuda = torch.cuda
    for name, value in (("is_available", True), ("current_device", 0),
                        ("get_device_name", "NVIDIA H100 80GB HBM3"),
                        ("memory_allocated", 123),
                        ("max_memory_allocated", 456)):
        monkeypatch.setattr(cuda, name, lambda *a, _v=value: _v)
    rep = _report(t_err, tmp_path, RuntimeError("CUDA error"))
    assert (rep["backend"], rep["device_name"], rep["memory_allocated"],
            rep["max_memory_allocated"]) == (
        "cuda", "NVIDIA H100 80GB HBM3", 123, 456)


@pytest.mark.parametrize("exc", [KeyboardInterrupt(), SystemExit(3)])
def test_record_passes_interrupts_through(tmp_path, exc):
    def fail():
        raise exc

    for mod in (t_err, j_err):
        with pytest.raises(type(exc)):
            mod.record(fail, error_dir=str(tmp_path))()
    assert not os.path.exists(tmp_path) or not os.listdir(tmp_path)


SCRIPTS = {
    "transient_then_ok": [RuntimeError("UNAVAILABLE: socket closed"),
                          OSError("Connection reset by peer"), None],
    "not_transient": [ValueError("shape mismatch"), None],
    "too_many": [RuntimeError("preempted")] * 5 + [None],
    "deadline": [TimeoutError("DEADLINE_EXCEEDED"), None],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_run_with_restarts_equals_jax(name, tmp_path, monkeypatch):
    results = []
    for mod in (t_err, j_err):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        script = iter(SCRIPTS[name])
        calls = []

        def step():
            calls.append(1)
            e = next(script)
            if e is not None:
                raise e
            return "done"

        try:
            out = mod.run_with_restarts(step, max_restarts=3, backoff_s=0,
                                        error_dir=str(tmp_path / mod.__name__))
        except Exception as e:  # noqa: BLE001
            out = type(e).__name__
        results.append((out, len(calls),
                        [mod.is_transient(e) for e in SCRIPTS[name] if e]))
    assert results[0] == results[1]


TICKS = [0.0, 0.5, 1.0, 1.25, 2.0, 2.1, 3.0, 3.7, 4.0, 4.05]


def test_step_timer_equals_jax(monkeypatch, tmp_path):
    """Five steps on the same scripted clock, the first a warm-up."""
    outs = []
    for mod in (t_prof, j_prof):
        clock = iter(TICKS)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer("train", warmup=1)
        for _ in range(5):
            with timer:
                pass
        path = tmp_path / f"{mod.__name__}.jsonl"
        timer.dump(str(path))
        outs.append((timer.summary(), path.read_text()))
    assert outs[0] == outs[1]
    assert outs[0][0]["train_count"] == 4.0
    assert t_prof.StepTimer().summary() == j_prof.StepTimer().summary() == {}


def test_param_count_report_equals_jax():
    """The tiny model's counts by the flax tree's top-level names: the
    port's module against JAX's report of the same parameters carried
    across by the weight bridge (``weights.flax_params``)."""
    model = U2CausalLM(U2ModelConfig.tiny(), dtype=torch.float32,
                       device="cpu")
    tree = flax_params(model)
    mine = t_prof.param_count_report(model)
    assert mine == j_prof.param_count_report(tree)
    assert mine["total"] == sum(p.numel() for p in model.parameters())
    sd = {"a.w": torch.zeros(3, 4), "a.b": torch.zeros(4), "c": torch.ones(2)}
    assert t_prof.param_count_report(sd) == {"a": 16, "c": 2, "total": 18}


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.trace(str(tmp_path / "tr")) as log_dir:
        torch.randn(16, 16) @ torch.randn(16, 16)
    with open(os.path.join(log_dir, t_prof.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_prof.device_memory_stats() == {}
