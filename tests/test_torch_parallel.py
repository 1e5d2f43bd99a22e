"""The port's meshes on ``torch.distributed`` against the JAX package's
sharded trainer, on the CPU.

Four gloo ranks, spawned once per file (``run_ranks``): each child imports
its worker from this module (``tests/`` on its path), joins a process group
through a ``file://`` store in the fixture's temporary directory (no port,
so xdist workers never meet), runs the file's scenario and saves what it
read. The JAX package runs the same steps in this process on 4 of the 8
CPU devices (``jax_sharded_run``: ``make_sharded_trainer`` with the port's
initial parameters put in its state), while the ranks run.

``U2ModelConfig.tiny()`` in fp32, cut to one layer a stack and its weights
drawn as ``tests/test_torch_train.py`` cuts and draws them (its limits were
measured there; the uncut tiny model's two-layer μ²tokenizer takes
gradients at fp32's noise, and one JAX compile of its sharded step takes
27 s on this CPU against 17), one global batch of 4 rows whose rows hold
13 to 22 valid targets, so that a mean of the ranks' means is not the
loss. The CLI runs the uncut ``--tiny`` model. This file
holds the (1, 2, 2) mesh and everything that is not a mesh's parity:
``test_torch_parallel_{data,fsdp,data_tensor}.py`` hold (4, 1, 1),
(1, 4, 1) and (2, 1, 2), one JAX compile a file.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.fast

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
B, S, SQ = 4, 24, 6
VALID = (24, 19, 13, 22)     # each row's attention mask
PROMPT_IGNORED = (11, 11, 16, 11)  # targets ignored at each row's start
STEPS, TOTAL = 3, 10
KW = dict(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.0)
FROZEN_KW = dict(learning_rate=1e-2, warmup_ratio=0.0)  # no decay
FROZEN = "vision_tower"
MESHES = {"1x2x2": (1, 2, 2), "4x1x1": (4, 1, 1), "1x4x1": (1, 4, 1),
          "2x1x2": (2, 1, 2)}
METRIC_RTOL = 1e-4


# ---------------------------------------------------------------------------
# shared by the mesh files
# ---------------------------------------------------------------------------

def model_config(cls):
    """``cls.tiny()`` with one layer a stack (tests/test_torch_train.py's
    ``_cfg``)."""
    import dataclasses

    base = cls.tiny()
    return dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_layers=1),
        u2t=dataclasses.replace(base.u2t, num_layers=1),
        llm=dataclasses.replace(base.llm, num_layers=1))


def global_batch():
    rs = np.random.RandomState(0)
    from u2tokenizer_torch.config import U2ModelConfig

    cfg = model_config(U2ModelConfig)
    d, h, w = cfg.vision.input_spatial
    ids = rs.randint(3, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array(VALID)[:, None]).astype(np.int32)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    for row, n in enumerate(PROMPT_IGNORED):
        labels[row, :n] = -100
    return {
        "input_ids": ids, "labels": labels, "attention_mask": mask,
        "images": rs.randn(B, cfg.num_chunks, d, h, w).astype(np.float32),
        "question_ids": rs.randint(3, cfg.llm.vocab_size,
                                   (B, SQ)).astype(np.int32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def port_model():
    """The tiny model in fp32 with ``tests/test_torch_train.py``'s fixed
    weights and re-drawn biases."""
    from test_torch_train import _draw_fixed_weights

    from u2tokenizer_torch.config import U2ModelConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM

    tm = U2CausalLM(model_config(U2ModelConfig), dtype=torch.float32,
                    device="cpu", seed=0)
    _draw_fixed_weights(tm)
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith(("bias", "cls_token")):
                p.copy_(torch.from_numpy(
                    (rs.randn(*p.shape) * 0.1).astype(np.float32)))
    return tm


def flax_flat(state_dict, model):
    """A whole state dict's parameters as the JAX package's flat dict."""
    from u2tokenizer_torch.weights import flax_path, torch_name

    modules = dict(model.named_modules())
    flat = {}
    for name, value in state_dict.items():
        path = flax_path(name, modules)[len("params/"):]
        _, transpose = torch_name(path, modules)
        value = value.detach().cpu().numpy()
        flat[path] = np.ascontiguousarray(value.T if transpose else value)
    return flat


def run_ranks(workdir, scenario: str, world: int = WORLD,
              module: str = "test_torch_parallel"):
    """Start ``world`` ranks of ``module.worker(rank, world, workdir,
    scenario)``; returns a function that waits for them and gives their
    outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [HERE, os.path.dirname(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    env.pop("RANK", None)
    procs = []
    for rank in range(world):
        code = (f"import {module} as t; "
                f"t.worker({rank}, {world}, {str(workdir)!r}, {scenario!r})")
        log = open(os.path.join(workdir, f"log_{scenario}_{rank}.txt"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       env=env, stdout=log,
                                       stderr=subprocess.STDOUT,
                                       cwd=str(workdir)), log))

    def wait(timeout: float = 240.0):
        t_end = time.time() + timeout
        failed = []
        for rank, (proc, log) in enumerate(procs):
            try:
                proc.wait(max(1.0, t_end - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
            if proc.returncode:
                with open(os.path.join(workdir,
                                       f"log_{scenario}_{rank}.txt")) as f:
                    failed.append(f"rank {rank}: {f.read()[-3000:]}")
        if failed:
            for proc, _ in procs:
                if proc.poll() is None:
                    proc.kill()
            raise AssertionError("\n".join(failed))
        return [torch.load(os.path.join(workdir, f"out_{scenario}_{r}.pt"),
                           weights_only=False) for r in range(world)]

    return wait


def worker(rank: int, world: int, workdir: str, scenario: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(
            workdir, f"pg_{scenario}"), rank=rank, world_size=world)
    try:
        spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
        out = SCENARIOS[scenario](spec, rank, workdir)
        torch.save(out, os.path.join(workdir, f"out_{scenario}_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def sharded_run(spec, mesh_shape, steps=STEPS, kw=KW, trainable=None,
                ce_chunk=0):
    """The port's sharded trainer from the spec's weights on ``mesh_shape``:
    (metrics a step, the whole state dict on rank 0, this rank's parameter
    and AdamW bytes, the state)."""
    from u2tokenizer_torch.config import MeshConfig, TrainConfig, U2ModelConfig
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.parallel.mesh import make_mesh
    from u2tokenizer_torch.train import sft

    model = U2CausalLM(model_config(U2ModelConfig), dtype=torch.float32,
                       device="cpu", seed=0)
    model.load_state_dict(spec["weights"])
    mesh = make_mesh(MeshConfig(*mesh_shape))
    state, step, slicer = sft.make_sharded_trainer(
        model, TrainConfig(**kw), TOTAL, mesh, trainable, ce_chunk)
    batch = slicer(torch_batch(spec["batch"]))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    local = sum(b.numel() for b in state.store.buffers.values())
    return metrics, state.state_dict(), 3 * 4 * local, state


def jax_sharded_run(mesh_shape, flat, batch, steps=STEPS, kw=KW):
    """The JAX package's ``make_sharded_trainer`` on 4 of the 8 CPU devices
    from the flat flax parameters ``flat``: (metrics a step, the final flat
    parameters, the largest parameter + optimizer-moment bytes a device
    holds)."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from u2tokenizer_tpu.config import MeshConfig, TrainConfig, U2ModelConfig
    from u2tokenizer_tpu.models.u2_model import U2CausalLM
    from u2tokenizer_tpu.parallel.mesh import make_mesh
    from u2tokenizer_tpu.train import sft

    model = U2CausalLM(model_config(U2ModelConfig), dtype=jnp.float32)
    mesh = make_mesh(MeshConfig(*mesh_shape), jax.devices()[:WORLD])
    tx = sft.make_optimizer(TrainConfig(**kw), TOTAL)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state, step, shardings = sft.make_sharded_trainer(
        model, tx, mesh, jax.random.PRNGKey(0), jb)
    params = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    state = state.replace(params=jax.device_put(
        params, jax.tree_util.tree_map(lambda x: x.sharding, state.params)))
    jb = jax.device_put(jb, shardings)
    metrics = []
    for _ in range(steps):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    held = {}
    for leaf in jax.tree_util.tree_leaves((state.params, state.opt_state)):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            for shard in leaf.addressable_shards:
                held[shard.device] = held.get(shard.device, 0) + \
                    shard.data.nbytes
    final = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        state.params["params"], sep="/").items()}
    return metrics, final, max(held.values())


def prepare(workdir, extra=None):
    """The spec every rank reads: the weights, the batch."""
    tm = port_model()
    spec = {"weights": {k: v.clone() for k, v in tm.state_dict().items()},
            "batch": global_batch(), **(extra or {})}
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    return tm, spec


def mesh_parity(workdir, name: str):
    """Run the ranks' and the JAX package's steps of mesh ``name``: (JAX's
    run, the ranks' outputs, the weights as a flat flax dict, the model)."""
    tm, spec = prepare(workdir, {"mesh": MESHES[name]})
    wait = run_ranks(workdir, "mesh")
    flat = flax_flat(spec["weights"], tm)
    jax_run = jax_sharded_run(MESHES[name], flat, spec["batch"])
    return jax_run, wait(), flat, tm


def check_mesh_parity(jax_run, outs, flat, tm, mesh_shape) -> None:
    """Every rank's metrics against JAX's at every step (METRIC_RTOL), each
    parameter's change after the steps by tests/test_torch_train.py's rules
    (the wk.bias noise leaves to 2 lr), and each rank's bytes against a JAX
    device's plus the FSDP padding."""
    from test_torch_train import DELTA_RTOL

    j_metrics, j_final, j_bytes = jax_run
    for rank, out in enumerate(outs):
        for step, (got, want) in enumerate(zip(out["metrics"], j_metrics)):
            for key in ("loss", "token_accuracy", "grad_norm"):
                np.testing.assert_allclose(
                    got[key], want[key], rtol=METRIC_RTOL,
                    err_msg=f"rank {rank} step {step} {key}")
    final = flax_flat(outs[0]["state"]["model"], tm)
    assert final.keys() == j_final.keys()
    lr = KW["learning_rate"]
    for path, want in j_final.items():
        d_want, d_got = want - flat[path], final[path] - flat[path]
        assert np.any(d_want != 0), path  # weight decay at least
        if path.endswith("wk/bias"):
            np.testing.assert_allclose(d_got, d_want, rtol=0, atol=2 * lr,
                                       err_msg=path)
        else:
            err = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
            assert err <= DELTA_RTOL, (path, err)
    padding = 3 * 4 * (mesh_shape[1] - 1)
    for rank, out in enumerate(outs):
        assert out["bytes"] <= j_bytes + padding, (rank, out["bytes"],
                                                   j_bytes)


def _mesh_scenario(spec, rank, workdir):
    metrics, saved, nbytes, _ = sharded_run(spec, spec["mesh"])
    return {"metrics": metrics, "state": saved, "bytes": nbytes}


# ---------------------------------------------------------------------------
# this file's scenario: (1, 2, 2) and everything else
# ---------------------------------------------------------------------------

def _collectives(rank):
    import torch.distributed as dist

    from u2tokenizer_torch.parallel import collectives as c

    x = torch.arange(2.0 * WORLD).reshape(WORLD, 2)[rank:rank + 1]
    x = x.clone().requires_grad_(True)
    gathered = c.all_gather_features(x)
    stacked = c.all_gather_features(x[0], tiled=False)
    # the loss counted once, on rank 0, as JAX's out_specs=P() reads
    # device 0's copy
    loss = (gathered ** 2).sum() * float(rank == 0)
    (grad,) = torch.autograd.grad(loss, x)
    v = torch.tensor(float(rank))
    mean = c.reduce_dict({"loss": v, "acc": v * 2})
    total = c.reduce_dict({"n": v}, average=False)
    batch_mean = c.global_batch_mean(
        torch.arange(4.0 * WORLD).reshape(WORLD, 4)[rank])
    dist.barrier()
    return {"gathered": gathered.detach(), "stacked": stacked.detach(),
            "grad": grad, "loss": float(mean["loss"]),
            "acc": float(mean["acc"]), "n": float(total["n"]),
            "batch_mean": float(batch_mean)}


def _cli_train(spec, rank):
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.train import sft

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    records = []
    make = sft.make_sharded_trainer

    def probed(*a, **kw):
        state, step, slicer = make(*a, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            records.append({k: float(v) for k, v in m.items()})
            return state, m

        return state, run, slicer

    sft.make_sharded_trainer = probed
    try:
        args = cli.build_parser().parse_args(
            spec["cli_argv"] + ["--batch-size", "1", "--mesh-fsdp", "2",
                                "--mesh-tensor", "2", "--output-dir",
                                spec["cli_out"]])
        args.fn(args, tokenizer=cli_tokenizer(spec["cli_data"]))
    finally:
        sft.make_sharded_trainer = make
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(key)
    return records


def _raises(spec):
    from u2tokenizer_torch.config import (MeshConfig, TrainConfig,
                                          U2ModelConfig)
    from u2tokenizer_torch.models.u2_model import U2CausalLM
    from u2tokenizer_torch.parallel.mesh import make_mesh
    from u2tokenizer_torch.train import sft

    out = {}
    try:
        make_mesh(MeshConfig(data=2))
    except ValueError as e:
        out["world"] = str(e)
    model = U2CausalLM(U2ModelConfig.tiny(), dtype=torch.float32,
                       device="cpu", seed=0)
    try:
        sft.make_sharded_trainer(model, TrainConfig(), TOTAL,
                                 make_mesh(MeshConfig(tensor=4)))
    except ValueError as e:
        out["kv_heads"] = str(e)
    return out


def _main_scenario(spec, rank, workdir):
    from u2tokenizer_torch.train.checkpoint import CheckpointManager

    out = {"collectives": _collectives(rank), "raises": _raises(spec)}
    metrics, saved, nbytes, state = sharded_run(spec, (1, 2, 2))
    shapes = {name: shape for kind in state.store.KINDS
              for name, _, _, _, shape in state.store.layout[kind]}
    attn = "llm.model.layers.0.self_attn"
    out.update(metrics=metrics, state=saved, bytes=nbytes,
               q_shape=shapes[f"{attn}.q_proj.weight"],
               o_shape=shapes[f"{attn}.o_proj.weight"])
    # the chunked loss on the same mesh
    out["chunked"] = sharded_run(spec, (1, 2, 2), ce_chunk=8)[0]
    # the frozen vision tower (the JAX package's test_frozen_vision_tower)
    out["frozen"] = sharded_run(spec, (1, 2, 2), steps=2, kw=FROZEN_KW,
                                trainable=lambda p: FROZEN not in p)[1]
    # a checkpoint saved under (1, 2, 2), loaded on (2, 1, 2)
    ckpt_dir = os.path.join(workdir, "ckpt")
    CheckpointManager(ckpt_dir).save(STEPS, state, force=True)
    _, _, _, other = sharded_run(spec, (2, 1, 2), steps=0)
    restored = CheckpointManager(ckpt_dir).restore(other)
    out["restored"] = restored.state_dict()
    out["restored_step"] = restored.step
    out["coords"] = state.mesh.coords
    out["rows"] = state.mesh.batch_rows(B)
    out["cli"] = _cli_train(spec, rank)
    return out


def _cli_one_scenario(spec, rank, workdir):
    """The one-process ``cli train`` (no launcher: one card) of the mesh
    run's global batch, its metrics a step."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.train import sft

    records = []
    make = sft.make_trainer

    def probed(*a, **kw):
        state, step = make(*a, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            records.append({k: float(v) for k, v in m.items()})
            return state, m

        return state, run

    sft.make_trainer = probed
    args = cli.build_parser().parse_args(
        spec["cli_argv"] + ["--batch-size", "2", "--output-dir",
                            os.path.join(workdir, "cli_one")])
    args.fn(args, tokenizer=cli_tokenizer(spec["cli_data"]))
    return records


SCENARIOS = {"mesh": _mesh_scenario, "main": _main_scenario,
             "cli_one": _cli_one_scenario}


# ---------------------------------------------------------------------------
# the CLI's files
# ---------------------------------------------------------------------------

CLI_ANSWERS = ("The study shows clear lungs and a normal heart size",
               "Small left pleural effusion without pneumothorax",
               "No focal consolidation is seen in either lung",
               "Mild cardiomegaly with a small pericardial effusion")


def write_cli_data(root):
    from u2tokenizer_torch.data.nifti import write_nifti

    rs = np.random.default_rng(0)
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        for i, answer in enumerate(CLI_ANSWERS):
            write_nifti(os.path.join(root, f"case{i}.nii.gz"),
                        rs.uniform(-1000, 400, (40, 48, 36)).astype(
                            np.float32))
            f.write(json.dumps({"image": f"case{i}.nii.gz",
                                "question": "Please describe the findings",
                                "answer": answer}) + "\n")


def cli_tokenizer(root):
    """A MockTokenizer that has met every word of the files in one order
    (it numbers words as it meets them, and each rank meets only its
    rows)."""
    from u2tokenizer_torch.data.datasets import FusedDataset
    from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer

    tok = MockTokenizer()
    ds = FusedDataset(root, "train.jsonl", tok, max_length=64,
                      return_image=False)
    for i in range(len(ds)):
        ds[i]
    return tok


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel")
    data = workdir / "cli_data"
    data.mkdir()
    write_cli_data(str(data))
    argv = ["train", "--tiny", "--device", "cpu", "--train-base-path",
            str(data), "--train-jsonl-path", "train.jsonl", "--max-steps",
            "3", "--max-length", "64", "--num-workers", "1",
            "--learning-rate", "1e-3"]
    tm, spec = prepare(workdir, {"cli_argv": argv, "cli_data": str(data),
                                 "cli_out": str(workdir / "cli_mesh")})
    wait = run_ranks(workdir, "main")
    wait_one = run_ranks(workdir, "cli_one", world=1)
    flat = flax_flat(spec["weights"], tm)
    jax_run = jax_sharded_run(MESHES["1x2x2"], flat, spec["batch"])
    records = wait_one()[0]
    return {"jax": jax_run, "outs": wait(), "flat": flat, "model": tm,
            "spec": spec, "cli_one": records, "workdir": workdir}


def test_mesh_1x2x2_matches_jax(runs):
    """(1, 2, 2): loss, token_accuracy and grad_norm at every step on every
    rank, the parameters after the steps, and each rank's bytes."""
    check_mesh_parity(runs["jax"], runs["outs"], runs["flat"], runs["model"],
                      MESHES["1x2x2"])


def test_tensor_dim_splits_q_and_o(runs):
    """Under tensor=2 q_proj keeps half its rows (column parallel) and
    o_proj half its columns (row parallel)."""
    cfg = runs["model"].cfg.llm
    for out in runs["outs"]:
        assert out["q_shape"] == (cfg.num_heads * cfg.head_dim // 2,
                                  cfg.hidden_size)
        assert out["o_shape"] == (cfg.hidden_size,
                                  cfg.num_heads * cfg.head_dim // 2)


def test_uneven_rows_need_the_global_count(runs):
    """The batch's rows hold different numbers of valid targets, so the
    mean of the ranks' losses (DDP's averaging) is not the loss: the parity
    above would catch it by more than ten times its limit."""
    from u2tokenizer_torch.train import sft

    tm = port_model()
    batch = torch_batch(runs["spec"]["batch"])
    loss_fn = sft.make_loss_fn()
    with torch.no_grad():
        whole = float(loss_fn(tm, batch)[0])
        halves = [float(loss_fn(tm, {k: v[i:i + 2] for k, v in
                                     batch.items()})[0]) for i in (0, 2)]
    np.testing.assert_allclose(whole, runs["jax"][0][0]["loss"], rtol=1e-5)
    assert abs(np.mean(halves) - whole) > 10 * METRIC_RTOL * whole


def test_chunked_loss_on_a_mesh(runs):
    """--ce-chunk on the (1, 2, 2) mesh (vocabulary gathered over the
    tensor dim a chunk at a time) gives the plain loss's numbers."""
    for out in runs["outs"]:
        for got, want in zip(out["chunked"], out["metrics"]):
            for key in ("loss", "token_accuracy", "grad_norm"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def test_frozen_vision_tower_on_a_mesh(runs):
    """--freeze-vision-tower under (1, 2, 2): after two steps the vision
    tower is bit for bit its start, the μ²tokenizer's query tokens moved."""
    frozen = runs["outs"][0]["frozen"]["model"]
    start = runs["spec"]["weights"]
    names = [n for n in start if n.startswith("vision_tower.")]
    assert names
    for name in names:
        assert torch.equal(frozen[name], start[name]), name
    assert not torch.equal(frozen["u2tokenizer.query_tokens"],
                           start["u2tokenizer.query_tokens"])


def _same_state(a, b):
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for name in a["model"]:
        assert torch.equal(a["model"][name].cpu(), b["model"][name].cpu()), \
            name
    oa, ob = a["optimizer"], b["optimizer"]
    for key in ("mini_step", "gradient_step", "acc"):
        assert oa[key] == ob[key], key
    sa, sb = oa["adamw"]["state"], ob["adamw"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key].cpu(), sb[i][key].cpu()), (i, key)
    ga, gb = oa["adamw"]["param_groups"], ob["adamw"]["param_groups"]
    assert ga == gb


def test_checkpoint_moves_between_meshes(runs):
    """A checkpoint saved under (1, 2, 2) is the whole one-card form: it
    loads into (2, 1, 2) and into the one-card trainer, equal."""
    from u2tokenizer_torch.config import TrainConfig
    from u2tokenizer_torch.train import sft
    from u2tokenizer_torch.train.checkpoint import CheckpointManager

    saved = runs["outs"][0]["state"]
    _same_state(runs["outs"][0]["restored"], saved)
    assert runs["outs"][0]["restored_step"] == STEPS
    tm = port_model()
    state, _ = sft.make_trainer(tm, TrainConfig(**KW), TOTAL)
    state = CheckpointManager(str(runs["workdir"] / "ckpt")).restore(state)
    _same_state(state.state_dict(), saved)


def test_collectives_match_jax(runs):
    """all_gather_features' values and gradients, reduce_dict and
    global_batch_mean against the JAX package's under shard_map on 4
    devices (tests/test_collectives.py)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from u2tokenizer_tpu.parallel import collectives as jc

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    x = jnp.arange(2.0 * WORLD).reshape(WORLD, 2)

    def loss(x):
        g = shard_map(lambda x: jc.all_gather_features(x, "data"), mesh,
                      in_specs=P("data"), out_specs=P(), check_rep=False)(x)
        return jnp.sum(g ** 2)

    grads = np.asarray(jax.grad(loss)(x))
    vals = jnp.arange(float(WORLD))

    def body(v):
        m = jc.reduce_dict({"loss": v[0], "acc": v[0] * 2}, "data")
        s = jc.reduce_dict({"n": v[0]}, "data", average=False)
        return m["loss"], m["acc"], s["n"]

    j_loss, j_acc, j_n = shard_map(body, mesh, in_specs=P("data"),
                                   out_specs=(P(), P(), P()))(vals)
    rows = jnp.arange(4.0 * WORLD).reshape(WORLD, 4)
    j_mean = shard_map(lambda r: jc.global_batch_mean(r, "data"), mesh,
                       in_specs=P("data"), out_specs=P())(rows)
    for rank, out in enumerate(runs["outs"]):
        c = out["collectives"]
        np.testing.assert_array_equal(c["gathered"].numpy(), np.asarray(x))
        np.testing.assert_array_equal(c["stacked"].numpy(), np.asarray(x))
        np.testing.assert_allclose(c["grad"].numpy(), grads[rank:rank + 1])
        np.testing.assert_allclose(
            (c["loss"], c["acc"], c["n"], c["batch_mean"]),
            (float(j_loss), float(j_acc), float(j_n), float(j_mean)))


def test_cli_train_on_a_mesh_matches_one_process(runs):
    """``cli train --mesh-fsdp 2 --mesh-tensor 2`` on 4 ranks (bf16
    compute, remat) gives the losses of the one-process ``cli train`` of
    the same global batch on the same files."""
    one = runs["cli_one"]
    assert len(one) == 3
    for rank, out in enumerate(runs["outs"]):
        assert len(out["cli"]) == 3
        for got, want in zip(out["cli"], one):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                                       err_msg=f"rank {rank}")
    assert (runs["workdir"] / "cli_mesh" / "checkpoints" / "3").is_dir()


def test_misuses_raise(runs):
    """A mesh that is not the world size, a tensor dim that does not divide
    the kv heads, and a mesh without a launcher each raise."""
    raised = runs["outs"][0]["raises"]
    assert "wants 2 devices, have 4" in raised["world"]
    assert "tensor=4" in raised["kv_heads"]
    assert "num_kv_heads=2" in raised["kv_heads"]
    from u2tokenizer_torch import cli

    args = cli.build_parser().parse_args(
        ["train", "--tiny", "--device", "cpu", "--train-base-path", ".",
         "--train-jsonl-path", "x.jsonl", "--mesh-tensor", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        args.fn(args)


def test_mesh_coordinates_follow_jax_device_order(runs):
    """Rank r sits where np.arange(world).reshape(data, fsdp, tensor) puts
    device r in the JAX package, and takes the rows of the global batch
    that data_sharding gives it (k = data_index * fsdp + fsdp_index)."""
    grid = np.arange(WORLD).reshape(MESHES["1x2x2"])
    for rank, out in enumerate(runs["outs"]):
        d, f, t = (int(i) for i in np.argwhere(grid == rank)[0])
        assert out["coords"] == {"data": d, "fsdp": f, "tensor": t}
        k = d * MESHES["1x2x2"][1] + f
        assert out["rows"] == slice(2 * k, 2 * k + 2)
