"""The port's dataset layer (``u2tokenizer_torch/data/datasets.py``)
against the JAX package's, on the CPU.

A jsonl of four cases over small seeded int16 ``.nii`` volumes (one of
them unreadable, one missing). Every item of ``FusedDataset`` in the
validation and training modes, ``dpo_mode``, ``return_image=False`` and
the linear (non-u2) transform, and the batches of ``DataLoader`` in their
shuffled order, against the JAX package's: token arrays, masks and strings
equal; volumes within 1e-4 (the port's transforms compute in fp32 where
the JAX package takes float64, ``tests/test_torch_transforms.py``). The
training augmentations draw from a torch generator in the port and numpy's
in the JAX package, so both datasets' transforms take the same scripted
draws here.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_transforms import Script, _script

from u2tokenizer_torch.data import datasets as t_ds
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_tpu.data import datasets as j_ds

pytestmark = pytest.mark.fast

ATOL = 1e-4
GEOMETRY = dict(num_chunks=2, chunk_depth=4, target_size=16)
CASES = [
    {"image": "a.nii", "question": "Describe the findings",
     "answer": "clear lungs and a normal heart", "chosen": "clear lungs",
     "rejected": "a mass"},
    {"image": "b.nii", "question": "What is seen in the liver ?",
     "answer": "a small cyst in segment four", "question_type": "VQA",
     "chosen": "a cyst", "rejected": "nothing"},
    {"image": "broken.nii", "question": "Describe", "answer": "x"},
    {"image": "c.nii", "question": "Any effusion ?",
     "answer": "no pleural effusion", "chosen": "no", "rejected": "yes"},
]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rs = np.random.RandomState(0)
    for i, name in enumerate(("a", "b", "c")):
        vol = rs.normal(40.0, 200.0, (20 + 2 * i, 18, 10))
        vol[:2] = -1000.0
        write_nifti(str(root / f"{name}.nii"), vol.astype(np.int16))
    (root / "broken.nii").write_bytes(b"not a nifti file")
    with open(root / "cases.jsonl", "w") as f:
        for case in CASES:
            f.write(json.dumps(case) + "\n")
        f.write("\n{not json\n")
    with open(root / "missing.jsonl", "w") as f:
        f.write(json.dumps({"image": "gone.nii", "question": "q",
                            "answer": "a"}) + "\n")
    return str(root)


def _tokenizer():
    """A MockTokenizer that has seen every word of the cases, so that the
    ids do not depend on the order in which loader threads read items."""
    tok = MockTokenizer()
    for case in CASES:
        prompt = tok.apply_chat_template(
            [{"role": "user", "content": "<im_patch>" + case["question"]}])
        tok(" ".join([prompt + case["answer"], prompt, case["question"],
                      case.get("chosen", ""), case.get("rejected", "")]))
    return tok


def _pair(data_dir, jsonl="cases.jsonl", **kw):
    kw = {"max_length": 300, "image_tokens_num": 4, "seed": 3, **GEOMETRY,
          **kw}
    jds = j_ds.FusedDataset(data_dir, jsonl, _tokenizer(), **kw)
    tds = t_ds.FusedDataset(data_dir, jsonl, _tokenizer(), device="cpu",
                            **kw)
    if getattr(jds, "image_transform", None) is not None and hasattr(
            jds.image_transform, "use_native"):
        jds.image_transform.use_native = False  # the Python path
    return jds, tds


def _same(t_item, j_item):
    assert (t_item is None) == (j_item is None)
    if t_item is None:
        return
    assert set(t_item) == set(j_item)
    for key, want in j_item.items():
        got = t_item[key]
        if isinstance(want, np.ndarray) and key == "image":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        elif isinstance(want, np.ndarray):
            assert got.dtype in (torch.int64, torch.int32)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
        else:
            assert got == want, key


def test_load_jsonl_skips_bad_lines(data_dir, capsys):
    path = os.path.join(data_dir, "cases.jsonl")
    assert t_ds.load_jsonl(path) == j_ds.load_jsonl(path) == CASES
    assert "Error loading json line" in capsys.readouterr().out


@pytest.mark.parametrize("idx", [0, 1, 3])
@pytest.mark.parametrize("mode", ["validation", "dpo", "no_image", "linear"])
def test_items_match_jax(data_dir, mode, idx):
    kw = {"validation": dict(data_type="validation"),
          "dpo": dict(data_type="validation", dpo_mode=True,
                      max_length=12),
          "no_image": dict(return_image=False),
          "linear": dict(data_type="validation",
                         enable_u2tokenizer=False)}[mode]
    jds, tds = _pair(data_dir, **kw)
    assert len(tds) == len(jds) == len(CASES)
    if mode == "linear":  # its (1, 32, 256, 256) out_shape, kept small
        jds.image_transform.out_shape = (4, 8, 8)
        tds.image_transform.out_shape = (4, 8, 8)
    _same(tds[idx], jds[idx])


@pytest.mark.parametrize("k,flips", [(1, (1,)), (2, ())])
def test_training_items_match_jax(data_dir, k, flips):
    """The training mode's augmented volume, both transforms given the
    same scripted draws, and its labels."""
    jds, tds = _pair(data_dir, data_type="training")
    draws = _script(k, flips, 0.06, -0.02)
    jds.image_transform.rng = Script(draws)
    tds.image_transform.draws = Script(draws)
    _same(tds[1], jds[1])


def test_eos_and_labels_at_max_length(data_dir):
    """A row cut at max_length keeps no eos; a short row has eos at its
    first pad, labels -100 over the question and the padding."""
    for max_length in (8, 40):
        jds, tds = _pair(data_dir, data_type="validation",
                         max_length=max_length)
        _same(tds[0], jds[0])
    item = tds[0]
    n = int(item["attention_mask"].sum())
    assert item["input_id"][n] == MockTokenizer.eos_token_id
    assert (item["label"][n + 1:] == t_ds.IGNORE_INDEX).all()


def test_corrupted_sample_resamples_like_jax(data_dir):
    """An unreadable volume is replaced by the item of a random index from
    the dataset's seeded Python generator: the same index in both."""
    jds, tds = _pair(data_dir, data_type="validation")
    for _ in range(3):
        _same(tds[2], jds[2])


def test_missing_file_gives_none(data_dir, capsys):
    jds, tds = _pair(data_dir, "missing.jsonl", data_type="validation")
    assert tds[0] is None and jds[0] is None
    assert "Image file not found" in capsys.readouterr().out
    assert t_ds.collate_batch([None]) is None


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_order_matches_jax(data_dir, workers):
    """Two epochs of shuffled batches, the broken case resampled, the last
    short batch dropped, question ids cut by the collator: the same
    batches as the JAX package's loader."""
    jds, tds = _pair(data_dir, data_type="validation")
    collate_j = lambda s: j_ds.collate_batch(s, question_ids_len=3)
    collate_t = lambda s: t_ds.collate_batch(s, question_ids_len=3)
    jl = j_ds.DataLoader(jds, batch_size=2, seed=5, num_workers=workers,
                         collate_fn=collate_j)
    tl = t_ds.DataLoader(tds, batch_size=2, seed=5, num_workers=workers,
                         collate_fn=collate_t)
    assert len(tl) == len(jl) == 2
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == 2
        for got, want in zip(tb, jb):
            assert set(got) == set(want)
            for key in ("input_ids", "labels", "attention_mask",
                        "question_ids"):
                np.testing.assert_array_equal(got[key].numpy(), want[key])
            np.testing.assert_allclose(got["images"].numpy(),
                                       want["images"], rtol=0, atol=ATOL)
            assert got["question_ids"].shape[1] == 3


def test_loader_shards_and_keeps_last(data_dir):
    """process_index/count stride disjoint shards; drop_last=False keeps
    the short batch; shuffle=False keeps the file's order."""
    _, tds = _pair(data_dir, return_image=False)
    tl = t_ds.DataLoader(tds, batch_size=3, shuffle=False, drop_last=False,
                         num_workers=1, collate_fn=lambda s: s)
    assert [[s["prompt_question"] for s in b] for b in tl] == [
        [c["question"] for c in CASES[:3]], [CASES[3]["question"]]]
    shards = [t_ds.DataLoader(tds, batch_size=1, seed=1, process_index=i,
                              process_count=2).batch_order()
              for i in range(2)]
    flat = sorted(int(i) for s in shards for b in s for i in b)
    assert flat == [0, 1, 2, 3]
