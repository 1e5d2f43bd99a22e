"""M3D-Bench on the port against the JAX package, on the CPU: the box
utilities, the prompt banks, every M3D dataset's samples, the task evaluations
(echo generators and the μ² ITR encoders) and ``cli eval-m3d`` for all
five tasks on ``U2ModelConfig.tiny()`` with ``SegConfig.tiny()``.

Both CLIs read one checkpoint directory: ``u2_config.json`` and a
``u2_params.msgpack`` written by the port's ``save_params_msgpack`` from
a flax tree with the seg head (every bias re-drawn from a numpy seed), so
the two packages run the same parameters; their JSON outputs are held
equal (greedy, bf16, as tests/test_torch_eval_cli.py holds ``cli eval``).
For the seg tasks the mock tokenizer's '[SEG]' is the id that greedy
decoding emits first on case 0, so the '[SEG]' branch is taken. Known
difference 18: without ``--checkpoint`` the JAX CLI cannot segment, while
the port draws the head from the seed. ``nltk`` and ``bert_score`` are
blocked, so the JAX package takes the metrics the port copies.
"""

import csv
import dataclasses
import json
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.config import GenerationConfig as TGen
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data import dataset_info as t_info
from u2tokenizer_torch.data import m3d_datasets as t_ds
from u2tokenizer_torch.data import prompt_templates as t_tpl
from u2tokenizer_torch.eval import m3d_bench as t_bench
from u2tokenizer_torch.models.generate import make_multimodal_generate_fn
from u2tokenizer_torch.models.quantize import cast_for_inference
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.train.checkpoint import save_params_msgpack
from u2tokenizer_torch.utils import box as t_box
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_torch.weights import flatten, load_flax_params
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu.config import SegConfig as JSeg
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.data import dataset_info as j_info
from u2tokenizer_tpu.data import m3d_datasets as j_ds
from u2tokenizer_tpu.data import prompt_templates as j_tpl
from u2tokenizer_tpu.eval import m3d_bench as j_bench
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel
from u2tokenizer_tpu.utils import box as j_box

pytestmark = pytest.mark.fast

MAX_LEN = 48
DICE_TOL = 0.01


@pytest.fixture(autouse=True)
def no_optional_packages(monkeypatch):
    for name in ("nltk", "nltk.translate", "nltk.translate.bleu_score",
                 "nltk.translate.meteor_score", "bert_score",
                 "sentence_transformers"):
        monkeypatch.setitem(sys.modules, name, None)


def _jcfg():
    return dataclasses.replace(JCfg.tiny(), seg=JSeg.tiny())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A synthetic M3D root in the reference layout at the tiny model's
    volume geometry: three cases, two masks, the seg split of tag 0000,
    the caption json, a VQA csv and a RefSeg csv."""
    path = tmp_path_factory.mktemp("m3d")
    cfg = _jcfg()
    rs = np.random.default_rng(0)
    d, h, w = cfg.vision.input_spatial
    for i in range(3):
        np.save(path / f"vol{i}.npy", rs.uniform(
            0, 1, (cfg.num_chunks, d, h, w)).astype(np.float32))
        (path / f"txt{i}.txt").write_text(
            f"Report number {i}. The liver is normal. Organ {i} is clear. "
            "No effusion is seen.")
    for i, (z, y, x) in enumerate(((0, 2, 1), (1, 1, 2))):
        mask = np.zeros((1, d, h, w), np.uint8)
        mask[0, z * d // 4: z * d // 4 + d // 2,
             y * h // 8: y * h // 8 + h // 2, x * w // 8: x * w // 8 + w // 3] = 1
        np.save(path / f"mask{i}.npy", mask)
    os.makedirs(path / "0000")
    split = [{"image": f"vol{i}.npy", "label": f"mask{i}.npy", "cls_id": 0}
             for i in range(2)]
    for mode in ("test", "train"):
        (path / "0000" / f"{mode}.json").write_text(json.dumps(split))
    (path / "cap.json").write_text(json.dumps({
        mode: [{"image": f"vol{i}.npy", "text": f"txt{i}.txt"}
               for i in range(3)] for mode in ("test", "train")}))
    with open(path / "vqa.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=[
            "Image Path", "Question", "Choice A", "Choice B", "Choice C",
            "Choice D", "Answer", "Answer Choice", "Question Type"])
        wr.writeheader()
        for i, ans in enumerate(("liver", "yes")):
            wr.writerow({"Image Path": f"vol{i}.npy", "Question": "What organ",
                         "Choice A": "liver", "Choice B": "lung",
                         "Choice C": "heart", "Choice D": "kidney",
                         "Answer": ans, "Answer Choice": "A",
                         "Question Type": "organ"})
    with open(path / "refseg.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=["Image", "Mask", "Question",
                                           "Answer"])
        wr.writeheader()
        for i in range(2):
            wr.writerow({"Image": f"vol{i}.npy", "Mask": f"mask{i}.npy",
                         "Question": f"segment the organ of case {i}",
                         "Answer": "the mask is [SEG]"})
    return str(path)


# --- utilities and banks ---------------------------------------------------

def test_box_utilities():
    mask = np.zeros((10, 20, 20))
    mask[2:5, 4:10, 6:18] = 1
    texts = ["it is at [0.20, 0.20, 0.30, 0.50, 0.50, 0.90] here",
             "[1, 2] then [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]", "no box", "[a, b]"]
    boxes = [[0, 0, 0, 1, 1, 1], [0, 0, 0.5, 1, 1, 1.5],
             [2, 2, 2, 3, 3, 3], [0.1, 0.1, 0.1, 0.1, 0.2, 0.2]]
    a = np.zeros((4, 4))
    a[:2] = 0.7
    for t, j in ((t_box, j_box),):
        assert t.mask_to_box(mask) == j.mask_to_box(mask)
        assert t.mask_to_box(np.zeros((4, 4, 4))) is None
        assert t.box_to_text(t.mask_to_box(mask)) == j.box_to_text(
            j.mask_to_box(mask))
        assert [t.extract_box_from_text(s) for s in texts] == [
            j.extract_box_from_text(s) for s in texts]
        assert [t.box_iou_3d(boxes[0], b) for b in boxes] == [
            j.box_iou_3d(boxes[0], b) for b in boxes]
        assert t.dice_score(a, a) == j.dice_score(a, a)
        assert t.dice_score(a, a.T) == j.dice_score(a, a.T)


def test_prompt_banks_and_dataset_info():
    for name in ("Caption_templates", "PosREC_templates", "PosREG_templates",
                 "Seg_templates"):
        assert getattr(t_tpl, name) == getattr(j_tpl, name), name
    public = {k for k in vars(j_tpl) if not k.startswith("_")}
    assert public <= set(vars(t_tpl))
    for k in public:
        assert getattr(t_tpl, k) == getattr(j_tpl, k), k
    assert t_info.dataset_info == j_info.dataset_info


# --- datasets --------------------------------------------------------------

def _datasets(mod, root, name, mode, proj_out_num=4):
    tok = MockTokenizer()
    kw = dict(proj_out_num=proj_out_num, mode=mode, seed=0)
    return {
        "cap": lambda: mod.M3DCapDataset(root, f"{root}/cap.json", tok,
                                         MAX_LEN, **kw),
        "vqa": lambda: mod.M3DVQADataset(root, f"{root}/vqa.csv", tok,
                                         MAX_LEN, **kw),
        "vqa_open": lambda: mod.M3DVQADataset(root, f"{root}/vqa.csv", tok,
                                              MAX_LEN, close_ended=False,
                                              **kw),
        "vqa_yn": lambda: mod.M3DVQAYNDataset(root, f"{root}/vqa.csv", tok,
                                              MAX_LEN, **kw),
        "rec": lambda: mod.M3DPosRECDataset(root, root, tok, MAX_LEN,
                                            tag="0000", **kw),
        "reg": lambda: mod.M3DPosREGDataset(root, root, tok, MAX_LEN,
                                            tag="0000", **kw),
        "seg": lambda: mod.M3DSegDataset(root, root, tok, MAX_LEN, tag="0000",
                                         **kw),
        "refseg": lambda: mod.M3DRefSegDataset(root, f"{root}/refseg.csv",
                                               tok, MAX_LEN, **kw),
        "itr": lambda: mod.M3DITRDataset(root, f"{root}/cap.json", tok, 16,
                                         **kw),
    }[name]()


def _same_sample(a, b):
    assert a is not None and b is not None
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["test", "train"])
@pytest.mark.parametrize("name", ["cap", "vqa", "vqa_open", "vqa_yn", "rec",
                                  "reg", "seg", "refseg", "itr"])
def test_datasets_match_jax(root, name, mode):
    """Every sample equal, volumes bit for bit. In training mode the port
    is handed a numpy Generator in place of its ``TorchDraws`` (known
    difference 5), so both augment a volume with the same draws."""
    t, j = _datasets(t_ds, root, name, mode), _datasets(j_ds, root, name,
                                                         mode)
    if mode == "train":
        t.draws = np.random.default_rng(0)
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        _same_sample(t[i], j[i])


def test_training_draws_come_from_the_seed(root):
    """Without numpy's draws the port augments from ``TorchDraws(seed)``:
    the same seed gives the same volumes, and some volume is changed."""
    a, b = (_datasets(t_ds, root, "cap", "train") for _ in range(2))
    plain = _datasets(t_ds, root, "cap", "test")
    moved = False
    for i in range(len(a)):
        x = a[i]["image"]
        np.testing.assert_array_equal(x, b[i]["image"])
        moved |= not np.array_equal(x, plain[i]["image"])
    assert moved


def test_concat_retry_and_truncation(root):
    cap = _datasets(t_ds, root, "cap", "test")
    uni = t_ds.build_uni_datasets([cap, _datasets(t_ds, root, "vqa", "test")])
    assert len(uni) == 5 and uni[3]["answer"] == "A. liver"
    with pytest.raises(IndexError):
        uni[5]
    for mod in (t_ds, j_ds):  # a missing volume re-draws another index
        broken = _datasets(mod, root, "cap", "test")
        broken.data_list[0] = {"image": "missing.npy", "text": "txt0.txt"}
        assert "Report number" in broken[0]["answer"]
    text = " ".join(f"Sentence {i} has words." for i in range(30))
    for budget in (5, 20, 200):
        got = [mod.truncate_text_random_sentences(
            text, budget, MockTokenizer(), random.Random(3))
            for mod in (t_ds, j_ds)]
        assert got[0] == got[1]


# --- evaluations -----------------------------------------------------------

def _echo(transform=lambda s: s["answer"]):
    return lambda sample, rng: transform(sample)


@pytest.mark.parametrize("pred", [
    lambda s: s["answer"], lambda s: "no box here",
    lambda s: "it is at [0.00, 0.00, 0.20, 0.40, 0.40, 0.60]"],
    ids=["oracle", "garbage", "shifted"])
def test_evaluate_rec_matches_jax(root, pred):
    t, j = (_datasets(m, root, "rec", "test") for m in (t_ds, j_ds))
    out = t_bench.evaluate_rec(t, _echo(pred))
    ref = j_bench.evaluate_rec(j, _echo(pred))
    assert out.to_json() == ref.to_json()
    assert len(out.rows) == 2


@pytest.mark.parametrize("bertscore", [False, True])
def test_evaluate_reg_matches_jax(root, bertscore):
    t, j = (_datasets(m, root, "reg", "test") for m in (t_ds, j_ds))
    pred = _echo(lambda s: s["answer"].split()[0] + " liver")
    out = t_bench.evaluate_reg(t, pred, compute_bertscore=bertscore)
    ref = j_bench.evaluate_reg(j, pred, compute_bertscore=bertscore)
    assert out.to_json() == ref.to_json()
    assert ("bert_f1" in out.metrics) == bertscore


def test_recall_and_itr_with_oracle_encoders(root):
    s = np.eye(4)
    s[0, 1] = 2.0
    for k in (1, 2, 4):
        assert t_bench.recall_at_k(s, k) == j_bench.recall_at_k(s, k)
    results = []
    for bench, mod in ((t_bench, t_ds), (j_bench, j_ds)):
        calls = {"i": 0, "t": 0}

        def enc(_, key):
            out = np.zeros((1, 4), np.float32)
            out[0, (calls[key] * (3 if key == "t" else 1)) % 4] = 1.0
            calls[key] += 1
            return out

        results.append(bench.evaluate_itr(
            _datasets(mod, root, "itr", "test"),
            lambda img: enc(img, "i"), lambda ids, m: enc(ids, "t")))
    assert results[0].to_json() == results[1].to_json()


@pytest.fixture(scope="module")
def params():
    """The tiny seg model's full flax tree, biases re-drawn (numpy seed)."""
    cfg = _jcfg()
    rs = np.random.RandomState(0)
    d, h, w = cfg.vision.input_spatial
    p = JModel(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.ones((1, 16), jnp.int32),
        jnp.asarray(rs.randn(1, cfg.num_chunks, d, h, w), jnp.float32),
        jnp.ones((1, 4), jnp.int32),
        jnp.asarray(rs.randn(1, 1, *cfg.seg.image_size), jnp.float32),
        jnp.zeros((1,), jnp.int32), method="forward_seg")
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(p["params"], sep="/").items()}
    for k in flat:
        if k.endswith(("bias", "cls_token")):
            flat[k] = (rs.randn(*flat[k].shape) * 0.1).astype(np.float32)
    return flat


def _port_model(flat, dtype=torch.float32):
    model = TModel(TCfg.from_dict(dataclasses.asdict(_jcfg())), dtype=dtype,
                   device="cpu")
    load_flax_params(model, flat)
    return model


def test_itr_with_u2_encoders_matches_jax(root, params):
    tree = {"params": traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in params.items()})}
    ref_i, ref_t = j_bench.make_u2_itr_encoders(
        JModel(_jcfg(), dtype=jnp.float32), tree)
    enc_i, enc_t = t_bench.make_u2_itr_encoders(_port_model(params))
    ds = _datasets(t_ds, root, "itr", "test")
    s = ds[0]
    np.testing.assert_allclose(enc_i(s["image"][None]),
                               np.asarray(ref_i(s["image"][None])),
                               rtol=1e-5, atol=1e-6)
    args = (s["input_id"][None], s["attention_mask"][None])
    np.testing.assert_allclose(enc_t(*args), np.asarray(ref_t(*args)),
                               rtol=1e-5, atol=1e-6)
    out = t_bench.evaluate_itr(ds, enc_i, enc_t)
    ref = j_bench.evaluate_itr(_datasets(j_ds, root, "itr", "test"),
                               ref_i, ref_t)
    assert out.to_json() == ref.to_json()


# --- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, params):
    """u2_config.json + u2_params.msgpack (the port's writer) of the tiny
    seg model; the JAX package's reader gives the tree back bit for bit."""
    path = tmp_path_factory.mktemp("ckpt")
    (path / "u2_config.json").write_text(json.dumps(dataclasses.asdict(
        _jcfg())))
    save_params_msgpack(str(path / "u2_params.msgpack"), {
        "params": traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in params.items()})})
    back = serialization.msgpack_restore(
        (path / "u2_params.msgpack").read_bytes())
    back = {k: np.asarray(v) for k, v in flatten(back).items()}
    assert set(back) == set(params)
    assert any(k.startswith("seg_module/") for k in back)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
    return str(path)


@pytest.fixture
def seeded_templates(monkeypatch):
    """The CLIs build their datasets without a seed, so each draws its
    prompt templates from fresh entropy (``random.Random(None)``), as the
    reference does; seed those draws with 0, as ``_datasets`` does."""
    unseeded = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: unseeded(
        0 if seed is None else seed))


class SegTokenizer(MockTokenizer):
    """The mock tokenizer with '[SEG]' mapped to a given id."""

    def __init__(self, seg_id):
        super().__init__()
        self.seg_id = seg_id

    def convert_tokens_to_ids(self, tokens):
        if tokens == "[SEG]":
            return self.seg_id
        return super().convert_tokens_to_ids(tokens)


def _first_token(root, params, task):
    """The id greedy decoding emits first on the task's case 0, as the
    CLI runs it (bf16, cast for inference)."""
    model = cast_for_inference(_port_model(params, torch.bfloat16))
    s = _datasets(t_ds, root, task, "test", model.cfg.proj_out_num)[0]
    gen = make_multimodal_generate_fn(model, TGen(max_new_tokens=1,
                                                  eos_token_id=1))
    toks = gen(*[torch.as_tensor(s[k])[None] for k in
                 ("input_id", "image", "question_ids")],
               torch.tensor([int(s["attention_mask"].sum())]))
    return int(toks[0, 0])


def _argv(task, root, ckpt, out):
    """The subcommand's arguments; with ``ckpt`` its config and weights
    (the JAX CLI builds its flagship config without ``--config``)."""
    argv = ["eval-m3d", "--task", task, "--tokenizer", "mock",
            "--data-root", root, "--seg-data-path", root,
            "--refseg-data-path", f"{root}/refseg.csv",
            "--cap-data-path", f"{root}/cap.json", "--max-length",
            str(MAX_LEN), "--max-new-tokens", "4", "--output", out]
    if ckpt:
        argv += ["--checkpoint", ckpt, "--config", f"{ckpt}/u2_config.json"]
    return argv


@pytest.mark.parametrize("task", ["rec", "reg", "seg", "refseg", "itr"])
def test_cli_eval_m3d_matches_jax(root, params, ckpt, tmp_path, task,
                                  monkeypatch, seeded_templates):
    seg_id = (_first_token(root, params, task)
              if task in ("seg", "refseg") else None)
    monkeypatch.setattr(j_cli, "_load_tokenizer",
                        lambda path: SegTokenizer(seg_id))
    # the JAX CLI's _init_or_load inits from case 0 (drawing its templates
    # once more) and then replaces every parameter by the checkpoint's
    # tree: hand it that tree, so both CLIs draw the same templates
    monkeypatch.setattr(j_cli, "_init_or_load",
                        lambda args, model, cfg, ds:
                        j_cli._load_pretrained_params(args.checkpoint, cfg))
    port, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    args = t_cli.build_parser().parse_args(
        _argv(task, root, ckpt, port) + ["--device", "cpu"])
    result = args.fn(args, tokenizer=SegTokenizer(seg_id))
    args = j_cli.build_parser().parse_args(_argv(task, root, ckpt, ref))
    args.fn(args)
    out, want = (json.loads(open(p).read()) for p in (port, ref))
    assert out == json.loads(result.to_json())
    if task in ("seg", "refseg"):
        # bf16 mask logits within an ulp of zero fall on either side of
        # the 0.5 threshold in the two packages (known difference 2): the
        # Dice scores agree to DICE_TOL, every other field exactly
        for rows in (out["rows"], want["rows"], [out["metrics"]],
                     [want["metrics"]]):
            for row in rows:
                row["dice"] = row.pop("dice", row.pop("mean_dice", None))
        for a, b in zip(out["rows"] + [out["metrics"]],
                        want["rows"] + [want["metrics"]]):
            assert abs(a.pop("dice") - b.pop("dice")) <= DICE_TOL
    assert out == want
    assert len(out["rows"]) == (3 if task == "itr" else 2)
    if task in ("seg", "refseg"):
        assert out["rows"][0]["has_seg"]  # the '[SEG]' branch was taken


def test_known_difference_18_seg_without_checkpoint(root, tmp_path,
                                                    monkeypatch):
    """Without ``--checkpoint`` the JAX CLI inits through the default
    ``__call__``, which never builds the seg head, and cannot segment; the
    port draws every parameter from the seed and runs."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dataclasses.asdict(_jcfg())))
    argv = _argv("seg", root, None, str(tmp_path / "out.json")) + [
        "--config", str(cfg), "--max-cases", "1"]
    args = j_cli.build_parser().parse_args(argv)
    with pytest.raises(Exception, match="seg_projector"):
        args.fn(args)
    args = t_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    result = args.fn(args)
    assert len(result.rows) == 1 and 0.0 <= result.rows[0]["dice"] <= 1.0


def test_cli_eval_m3d_needs_the_head_and_a_gpu(root, tmp_path, monkeypatch):
    """A seg task on a config without the head raises; without a GPU the
    subcommand raises unless given ``--device cpu``."""
    argv = _argv("seg", root, None, str(tmp_path / "o.json")) + ["--tiny"]
    args = t_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="seg.enable"):
        args.fn(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = t_cli.build_parser().parse_args(
        _argv("itr", root, None, str(tmp_path / "o.json")) + ["--tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        args.fn(args)
