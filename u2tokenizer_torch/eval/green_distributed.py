"""Multi-process GREEN scoring (counterpart of
``u2tokenizer_tpu/eval/green_distributed.py``).

Each rank of an initialised ``torch.distributed`` group scores a strided
shard of the (reference, prediction) pairs with its own judge (on its own
card under ``torchrun``); the rows are exchanged by the JAX package's
protocol, so every rank ends with the full score list: each rank's rows as
JSON bytes, padded to the longest rank's length, all-gathered as uint8
tensors with the lengths beside them (on the card under NCCL, on the host
under gloo), and parsed back, so the rows come back JSON-typed as they do
in the JAX package (a group of one exchanges its rows too, where the JAX
package's single process keeps them as they are). Without a group there is
one process, which scores every pair. No pickle crosses the wire.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .green import GreenResult, GreenScorer


def _process_info():
    """(rank, world size) of the initialised group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_objects(local: list) -> List[list]:
    """Gather a list of JSON-serializable objects from every rank (through
    the group whenever one is initialised, a group of one included)."""
    if not (dist.is_available() and dist.is_initialized()):
        return [local]
    world = dist.get_world_size()
    device = torch.device("cpu")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    payload = json.dumps(local).encode()
    n = torch.tensor([len(payload)], dtype=torch.int32, device=device)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(x) for x in lens]
    buf = torch.zeros(max(lens), dtype=torch.uint8, device=device)
    buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                          dtype=torch.uint8).to(device)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    return [json.loads(bytes(b[:ln].cpu().numpy()).decode())
            for b, ln in zip(bufs, lens)]


def distributed_green(
    scorer: GreenScorer,
    refs: Sequence[str],
    hyps: Sequence[str],
) -> Optional[GreenResult]:
    """Score pairs sharded across ranks; every rank returns the merged
    result, its ``summary`` the rank's own shard's (rank-0-only consumers
    can test ``torch.distributed.get_rank() == 0``)."""
    rank, world = _process_info()
    local_idx = list(range(rank, len(refs), world))
    local_refs = [refs[i] for i in local_idx]
    local_hyps = [hyps[i] for i in local_idx]

    local = scorer(local_refs, local_hyps) if local_refs else GreenResult(
        0.0, 0.0, [], "", [])
    local_rows = [{"index": i, "green": s, "row": r}
                  for i, s, r in zip(local_idx, local.scores, local.rows)]

    all_rows = [row for shard in _allgather_objects(local_rows)
                for row in shard]
    all_rows.sort(key=lambda r: r["index"])
    scores = [r["green"] for r in all_rows]
    valid = [s for s in scores if s is not None]
    mean = float(np.mean(valid)) if valid else 0.0
    std = float(np.std(valid)) if valid else 0.0
    return GreenResult(mean, std, scores, local.summary,
                       [r["row"] for r in all_rows])
