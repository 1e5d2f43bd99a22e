"""``eval/green_distributed.distributed_green`` on gloo ranks against the
JAX package's ``distributed_green`` and ``GreenScorer``, on the CPU.

World 3 over 7 pairs and world 4 over 3 pairs (the last rank's shard is
empty), spawned together (``test_torch_parallel.run_ranks``; each child
imports its worker from this module). Judges: the letters judge of
``tests/test_misc_components.py`` (one response for every prompt) and one
that picks among ``tests/test_green.py``'s responses by the prediction's
number, so that the rows differ. Every rank's merged result equals the JAX
package's field for field (its rows JSON-typed, as the JAX package's come
back from its exchange), and its summary is its own shard's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

pytestmark = pytest.mark.fast

CASES = {"w3": (3, 7), "w4": (4, 3)}  # world, pairs


def pairs(n: int):
    refs = [f"reference {i} the lungs are clear" for i in range(n)]
    hyps = [f"prediction {i} small effusion" for i in range(n)]
    return refs, hyps


def make_judge(responses, mixed: bool):
    """A judge: the letters response for every prompt, or (``mixed``) the
    response that the prediction's number picks."""
    def judge(prompts):
        if not mixed:
            return [responses[0]] * len(prompts)
        out = []
        for p in prompts:
            i = int(p.split("prediction ")[1].split()[0])
            out.append(responses[i % len(responses)])
        return out
    return judge


def worker(rank: int, world: int, workdir: str, scenario: str) -> None:
    import torch.distributed as dist

    from u2tokenizer_torch.eval.green import GreenScorer
    from u2tokenizer_torch.eval.green_distributed import distributed_green

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        workdir, f"pg_{scenario}"), rank=rank, world_size=world)
    try:
        spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
        refs, hyps = pairs(CASES[scenario][1])
        out = {}
        for mixed in (False, True):
            for summary in (False, True):
                scorer = GreenScorer(make_judge(spec["responses"], mixed),
                                     compute_summary_stats=summary)
                out[(mixed, summary)] = dataclasses.asdict(
                    distributed_green(scorer, refs, hyps))
        torch.save(out, os.path.join(workdir, f"out_{scenario}_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_green import (RESPONSE_LETTERS, RESPONSE_NO_ERRORS,
                            RESPONSE_NO_MATCH, RESPONSE_NUMBERS)

    workdir = tmp_path_factory.mktemp("green_distributed")
    responses = [RESPONSE_LETTERS, RESPONSE_NUMBERS, RESPONSE_NO_ERRORS,
                 RESPONSE_NO_MATCH]
    torch.save({"responses": responses}, os.path.join(workdir, "spec.pt"))
    waits = {name: run_ranks(workdir, name, world,
                             module="test_torch_green_distributed")
             for name, (world, _) in CASES.items()}
    return responses, {name: wait() for name, wait in waits.items()}


@pytest.mark.parametrize("mixed", [False, True], ids=["letters", "mixed"])
@pytest.mark.parametrize("case", list(CASES))
def test_distributed_green_matches_jax(runs, case, mixed):
    """Every rank's merged result equals the JAX package's
    ``distributed_green`` (one process: every pair) field for field."""
    from u2tokenizer_tpu.eval.green import GreenScorer as JScorer
    from u2tokenizer_tpu.eval.green_distributed import (
        distributed_green as j_distributed_green)

    responses, outs = runs
    world, n = CASES[case]
    refs, hyps = pairs(n)
    want = j_distributed_green(
        JScorer(make_judge(responses, mixed), compute_summary_stats=False),
        refs, hyps)
    rows = json.loads(json.dumps(want.rows))
    for rank, out in enumerate(outs[case]):
        got = out[(mixed, False)]
        assert got["scores"] == want.scores, rank
        np.testing.assert_allclose((got["mean"], got["std"]),
                                   (want.mean, want.std), rtol=1e-12)
        assert got["rows"] == rows, rank
        assert got["summary"] == want.summary == ""


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_keeps_its_own_summary(runs, case):
    """The summary is the rank's own shard's (strided by rank), as in the
    JAX package; an empty shard's is empty, its rows still merged."""
    from u2tokenizer_torch.eval.green import GreenScorer

    responses, outs = runs
    world, n = CASES[case]
    refs, hyps = pairs(n)
    for rank, out in enumerate(outs[case]):
        got = out[(True, True)]
        shard = list(range(rank, n, world))
        if not shard:
            assert got["summary"] == ""
        else:
            own = GreenScorer(make_judge(responses, True))(
                [refs[i] for i in shard], [hyps[i] for i in shard])
            assert got["summary"] == own.summary
        assert len(got["scores"]) == n
