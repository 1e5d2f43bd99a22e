"""Data preparation in the port against the JAX package, on the CPU: the
term dictionary, the synthesis operations (a scripted backend), the
per-dataset converters (their jsonl byte for byte), the AMOS-MM and
CT-RATE datasets (tokens equal, images within ``IMAGE_TOL``), the offline
resizer (within ``RESIZE_TOL``) and the synthesis client against the
port's own ``serve-llm`` server (``TextLMServer``, tiny preset)."""

import csv
import json
import os

import numpy as np
import pytest

from u2tokenizer_torch.data import amos_ct_datasets as t_amos
from u2tokenizer_torch.data import converters as t_conv
from u2tokenizer_torch.data import synthesis as t_syn
from u2tokenizer_torch.data import term_dictionary as t_td
from u2tokenizer_torch.data.nifti import read_nifti, write_nifti
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_tpu.data import amos_ct_datasets as j_amos
from u2tokenizer_tpu.data import converters as j_conv
from u2tokenizer_tpu.data import synthesis as j_syn
from u2tokenizer_tpu.data import term_dictionary as j_td

pytestmark = pytest.mark.fast

# [0, 1] images: the port's fp32 transforms against the JAX package's
# float64 numpy/scipy path (``tests/test_torch_transforms.py`` holds the
# same 1e-4)
IMAGE_TOL = 1e-4
# the resizer keeps CT units (here up to 1000, where one fp32 ulp is 6e-5):
# fp32 sums of a few dozen taps against float64 ones differ by a few ulps
# (2.4e-4 seen); 1e-6 of the values' scale
RESIZE_TOL = 1e-6 * 1000


# --- the term dictionary ---

_ORGANS = sorted(j_td._ORGAN_FACTS)
TERM_GROUPS = {
    "organs": _ORGANS,
    "laterality": [f"{side} {o}" for o in _ORGANS[:20]
                   for side in ("left", "right")]
    + [f"{o} left" for o in _ORGANS[:10]],
    "numbered": [f"{o} {n}" for o in _ORGANS[:10] for n in (1, 3)]
    + [f"{o.replace(' ', '_').title()}" for o in _ORGANS[:10]],
    "ribs_and_spine": [f"rib {side} {n}" for side in ("left", "right")
                       for n in range(1, 13)]
    + [f"vertebrae {lv}{n}" for lv, top in (("C", 7), ("T", 13), ("L", 5))
       for n in range(1, top + 1)]
    + ["cervical spine C3", "lumbar spine L5", "13th thoracic vertebra"],
    "lung_lobes": [f"lung {lobe} lobe {side}"
                   for lobe in ("upper", "middle", "lower")
                   for side in ("left", "right")],
    "lesions": [f"{o} {k}" for o in ("liver", "kidney", "pancreatic",
                                     "left suprarenal", "colon", "")
                for k in j_td._LESION_KINDS] + ["liver tumor 03",
                                                "kidney cysts", "bone kyst"],
    "unknown": ["zygomatic arch", "", "  Spaced   Term  ", "x" * 40],
}


@pytest.mark.parametrize("group", sorted(TERM_GROUPS))
def test_term_dictionary_equals_jax(group):
    for term in TERM_GROUPS[group]:
        assert t_td.term_descriptions(term) == j_td.term_descriptions(term)
        assert t_td.describe(term) == j_td.describe(term)
        assert t_td.term_dictionary[term] == j_td.term_dictionary[term]
        assert t_td.term_dictionary.get(term) == j_td.term_dictionary.get(term)
        assert term in t_td.term_dictionary


# --- the synthesis operations ---

def scripted(prompt: str) -> str:
    """A deterministic backend: answers by the prompt's kind, with a
    <think> block on some, malformed JSON on some QA prompts."""
    h = sum(map(ord, prompt)) % 7
    if prompt.startswith("You are reviewing"):
        return ["YES", "no", "<think>hmm</think> Yes, correct"][h % 3]
    if "question/answer" in prompt or "JSON" in prompt:
        if h == 0:
            return "no json here"
        if h == 1:
            return "[{broken"
        return ("```json\n[" + ", ".join(
            json.dumps({"question": f"Q{i}-{h}", "answer": f"A{i}"})
            for i in range(h)) + ', {"q": 1}]\n```')
    think = f"<think>reason {h}</think>" if h % 2 else ""
    return f"{think}out {h} {len(prompt)}\n"


def test_synthesis_operations_equal_jax():
    reports = ["The lungs are clear.", "Small effusion on the left.",
               "No acute findings; the heart is normal in size."]
    for r in reports:
        for op in ("rewrite_report", "translate_report"):
            assert (getattr(t_syn, op)(scripted, r)
                    == getattr(j_syn, op)(scripted, r))
        for n in (1, 3):
            assert (t_syn.generate_qa_pairs(scripted, r, n)
                    == j_syn.generate_qa_pairs(scripted, r, n))
        for q, a in (("Is there an effusion?", "yes"), ("Heart?", "normal")):
            assert (t_syn.filter_vqa_pair(scripted, r, q, a)
                    == j_syn.filter_vqa_pair(scripted, r, q, a))
            assert (t_syn.refine_thinking(scripted, r, q, "draft", a)
                    == j_syn.refine_thinking(scripted, r, q, "draft", a))
    for text in ("<think> a </think> b", "plain", "<think>x</think>"):
        assert t_syn.split_thinking(text) == j_syn.split_thinking(text)
    assert t_syn.LLMClientConfig() == t_syn.LLMClientConfig(
        **vars(j_syn.LLMClientConfig()))


def test_synthesize_dataset_equals_jax(capsys):
    rows = [{"image": f"v{i}.nii.gz", "question": "q", "answer": f"r {i}"}
            for i in range(5)] + [{"image": "w.nii.gz", "report": "rep"}]
    calls = []

    def failing(prompt):  # the fourth call raises: the row is skipped
        calls.append(prompt)
        if len(calls) % 9 == 4:
            raise RuntimeError("backend down")
        return scripted(prompt)

    outs = []
    for mod in (t_syn, j_syn):
        calls.clear()
        outs.append(mod.synthesize_dataset(
            failing, rows, ops=("rewrite", "translate", "qa"),
            qa_per_report=2))
    assert outs[0] == outs[1] and len(outs[0]) > len(rows)
    printed = capsys.readouterr().out.splitlines()
    half = len(printed) // 2
    assert printed[:half] == printed[half:] and "backend down" in printed[0]


def test_jsonl_utilities_equal_jax(tmp_path):
    src = tmp_path / "x.json"
    src.write_text(json.dumps({"train": [{"a": 1}, {"b": "é"}]}))
    (tmp_path / "y.jsonl").write_text('{"c": 3}\n\n  \n{"d": 4}\n')
    outs = []
    for mod in (t_syn, j_syn):
        a, m = (str(tmp_path / f"{mod.__name__}.{n}.jsonl")
                for n in ("a", "m"))
        mod.json_to_jsonl(str(src), a, key="train")
        mod.merge_jsonl([a, str(tmp_path / "y.jsonl"), a], m)
        outs.append((open(a).read(), open(m).read()))
    assert outs[0] == outs[1]


# --- the converters ---

def _amos_json(root):
    data = {"training": [], "validation": []}
    for split, n in (("training", 6), ("validation", 3)):
        for i in range(n):
            data[split].append({
                "image": f"./imagesTr/amos_{split}_{i}.nii.gz",
                "meta": {"age": 40 + i, "sex": "F" if i % 2 else "M"},
                "labels": {
                    "report": {"findings": {
                        "chest": f"clear lungs {i}" if i != 2 else "",
                        "abdomen": f"liver normal, spleen {i} cm",
                        "pelvis": "" if i % 3 else f"bladder {i}"}},
                    "qa": [{"question": f"Organ {i}?",
                            "options": {"A": "liver", "B": "spleen",
                                        "C": "kidney", "D": "heart"},
                            "answer": "ABCD"[i % 4]}] * (i % 2 + 1)}})
    path = os.path.join(root, "dataset.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def _ct_rate_csv(root):
    path = os.path.join(root, "reports.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["VolumeName", "Findings_EN", "Impressions_EN"])
        w.writeheader()
        for i in range(5):
            w.writerow({"VolumeName": f"train_{i}_a_{i + 1}.nii.gz",
                        "Findings_EN": "" if i == 3 else f"nodule {i} mm, ö",
                        "Impressions_EN": f"impression {i}"})
    return path


def _atlas_tree(root):
    top = os.path.join(root, "atlas")
    for i, text in enumerate(["liver lesion\n", "", "kidney cyst  "]):
        os.makedirs(os.path.join(top, f"BDMAP_{i:04d}"))
        with open(os.path.join(top, f"BDMAP_{i:04d}", "report.txt"),
                  "w") as f:
            f.write(text)
    os.makedirs(os.path.join(top, "BDMAP_0009"))  # no report.txt
    return top


def _refseg(root):
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "masks", "s0"))
    for i in range(2):
        mask = (rng.random((6, 5, 4)) > 0.8).astype(np.float32)
        write_nifti(os.path.join(root, "masks", "s0", f"m{i}.nii.gz"), mask)
    path = os.path.join(root, "refseg.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["Image", "Mask", "Question", "Answer"])
        w.writeheader()
        for i in range(3):  # the third mask is missing: skipped
            w.writerow({"Image": f"s0/ct{i}.npy", "Mask": f"s0/m{i}.nii.gz",
                        "Question": f"Where is the lesion {i}?",
                        "Answer": "It is here: [SEG]."})
    return path


def _stage_input(root):
    path = os.path.join(root, "stage_in.jsonl")
    with open(path, "w") as f:
        for i in range(4):
            f.write(json.dumps({"image": f"v{i}", "question": f"q{i}?",
                                "answer": f"report {i} text"}) + "\n")
    return path


CONVERTERS = {
    "amos_mm_extract_qa": lambda m, r, out: m.amos_mm_extract_qa(
        _amos_json(r), out, splits=("validation", "training")),
    "amos_mm_reports": lambda m, r, out: m.amos_mm_reports(
        _amos_json(r), out, seed=3),
    "amos_mm_report_choice_questions":
        lambda m, r, out: m.amos_mm_report_choice_questions(
            _amos_json(r), out, splits=("training", "validation"),
            n_choices=4, seed=5),
    "ct_rate_reports": lambda m, r, out: m.ct_rate_reports(
        _ct_rate_csv(r), out, split="valid", seed=2),
    "abdomen_atlas_reports_tree": lambda m, r, out: m.abdomen_atlas_reports(
        _atlas_tree(r), out, seed=1),
    "abdomen_atlas_reports_rows": lambda m, r, out: m.abdomen_atlas_reports(
        [{"image": "a", "answer": "x"}, {"image": "b", "answer": ""}], out),
    "m3d_refseg_convert": lambda m, r, out: m.m3d_refseg_convert(
        _refseg(r), os.path.join(r, "masks"), out),
    "rewrite_jsonl": lambda m, r, out: m.rewrite_jsonl(
        scripted, _stage_input(r), out, max_rows=3),
    "translate_jsonl": lambda m, r, out: m.translate_jsonl(
        scripted, _stage_input(r), out),
    "thinking_synthesis_jsonl": lambda m, r, out: m.thinking_synthesis_jsonl(
        scripted, _stage_input(r), out, max_rows=2),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_jsonl_equals_jax(name, tmp_path):
    files = []
    for mod in (t_conv, j_conv):
        root = tmp_path / mod.__name__.split(".")[0]
        root.mkdir()
        out = str(root / "out" / "rows.jsonl")
        n = CONVERTERS[name](mod, str(root), out)
        data = open(out, "rb").read()
        files.append(data.replace(str(root).encode(), b"ROOT"))
        assert n == len(data.splitlines())
    assert files[0] == files[1]
    assert files[0] or name == "abdomen_atlas_reports_rows"


def test_ct_rate_volume_paths_equal_jax():
    for name in ("train_1_a_1.nii.gz", "valid_17_b_3.nii", "train_9_1_0"):
        assert (t_conv.ct_rate_volume_path(name)
                == j_conv.ct_rate_volume_path(name))
        assert (t_amos.ct_rate_volume_path(name)
                == j_amos.ct_rate_volume_path(name))


# --- the AMOS-MM and CT-RATE datasets ---

@pytest.fixture(scope="module")
def amos_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("amos")
    rng = np.random.default_rng(0)
    (root / "imagesTr").mkdir()
    cases = []
    for i, findings in enumerate(["clear lungs", "", "a small nodule"]):
        vol = rng.uniform(-1000, 400, (36, 40, 18)).astype(np.float32)
        vol[:4] = -1024  # a border the crop takes off
        write_nifti(str(root / "imagesTr" / f"amos_{i}.nii.gz"), vol)
        cases.append({"image": f"imagesTr/amos_{i}.nii.gz", "labels": {
            "report": {"findings": {"chest": findings, "abdomen": "normal",
                                    "pelvis": ""}}}})
    ann = {"training": cases, "validation": cases[:1], "testing": []}
    (root / "dataset.json").write_text(json.dumps(ann))
    return str(root), str(root / "dataset.json")


def _assert_items_equal(t_item, j_item):
    assert set(t_item) == set(j_item)
    for key, j_val in j_item.items():
        t_val = t_item[key]
        if key == "image":
            assert tuple(t_val.shape) == j_val.shape
            np.testing.assert_allclose(t_val.numpy(), j_val, rtol=0,
                                       atol=IMAGE_TOL)
        elif isinstance(j_val, np.ndarray):
            np.testing.assert_array_equal(t_val.numpy(), j_val)
        else:
            assert t_val == j_val, key


@pytest.mark.parametrize("data_type,part,idx", [
    ("validation", "chest", 0), ("training", "chest", 0),
    ("training", "chest", 1), ("training", "abdomen", 2)])
def test_amos_mrg_items_equal_jax(amos_root, data_type, part, idx):
    """Tokens equal; images within IMAGE_TOL; in training both take the
    same scripted draws (a numpy Generator of one seed each); index 1's
    empty chest findings resample the same case in both."""
    base, jp = amos_root
    tok = MockTokenizer()
    kw = dict(image_tokens_num=4, categorize=("findings", part),
              data_type=data_type, seed=7)
    t_ds = t_amos.AMOSMRGDataset(base, jp, tok, 48, device="cpu", **kw)
    j_ds = j_amos.AMOSMRGDataset(base, jp, tok, 48, **kw)
    t_ds.draws, j_ds.rng = (np.random.default_rng(11) for _ in range(2))
    _assert_items_equal(t_ds[idx], j_ds[idx])
    assert t_ds._pyrng.random() == j_ds._pyrng.random()


def test_amos_missing_image_and_bad_part(amos_root, tmp_path):
    base, jp = amos_root
    tok = MockTokenizer()
    for mod, kw in ((t_amos, {"device": "cpu"}), (j_amos, {})):
        assert mod.AMOSMRGDataset(str(tmp_path), jp, tok, 48,
                                  **kw)[0] is None
        with pytest.raises(ValueError):
            mod.AMOSMRGDataset(base, jp, tok, 48,
                               categorize=("findings", "head"), **kw)


def test_ct_rate_items_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    vol_dir = tmp_path / "train" / "train_9" / "train_9_1"
    vol_dir.mkdir(parents=True)
    write_nifti(str(vol_dir / "train_9_1_0.nii.gz"),
                rng.uniform(-1000, 400, (40, 44, 16)).astype(np.int16))
    write_nifti(str(tmp_path / "plain.nii"),
                rng.uniform(0, 9, (20, 24, 12)).astype(np.float32))
    ann = [{"VolumeName": "train_9_1_0.nii.gz", "question": "describe",
            "answer": "all clear"},
           {"image": "plain.nii", "answer": "no question given"},
           {"VolumeName": "train_9_1_9.nii.gz", "answer": "missing"}]
    tok = MockTokenizer()
    kw = dict(image_tokens_num=4, output_size=(8, 32, 32))
    t_ds = t_amos.CTRateCapDataset(str(tmp_path), ann, tok, 48,
                                   device="cpu", **kw)
    j_ds = j_amos.CTRateCapDataset(str(tmp_path), ann, tok, 48, **kw)
    for i in range(2):
        _assert_items_equal(t_ds[i], j_ds[i])
    assert t_ds[2] is None and j_ds[2] is None


# --- the offline resizer ---

@pytest.mark.parametrize("shape,target", [((64, 80, 10), 32),
                                          ((20, 24, 6), 32)])
def test_adaptive_resize_file_equals_jax(tmp_path, shape, target):
    """Shrunk (anti-aliased) or, at a ratio of 1 or more, kept: the
    port's NIfTI within RESIZE_TOL of the JAX package's."""
    rng = np.random.default_rng(4)
    src = str(tmp_path / "in.nii.gz")
    write_nifti(src, rng.uniform(-1000, 1000, shape).astype(np.float32))
    t_out, j_out = str(tmp_path / "t.nii.gz"), str(tmp_path / "j.nii.gz")
    t_amos.adaptive_resize_file(src, t_out, target, device="cpu")
    j_amos.adaptive_resize_file(src, j_out, target)
    a, b = read_nifti(t_out), read_nifti(j_out)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=RESIZE_TOL)


def test_bulk_adaptive_resize_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    (src / "a" / "b").mkdir(parents=True)
    write_nifti(str(src / "a" / "x.nii.gz"),
                rng.uniform(0, 1, (48, 40, 5)).astype(np.float32))
    write_nifti(str(src / "a" / "b" / "y.nii"),
                rng.uniform(0, 1, (16, 16, 5)).astype(np.float32))
    (src / "a" / "b" / "bad.nii").write_bytes(b"not a nifti")
    (src / "notes.txt").write_text("skipped")
    counts, trees = [], []
    for name, mod, kw in (("t", t_amos, {"device": "cpu"}),
                          ("j", j_amos, {})):
        dst = tmp_path / name
        counts.append(mod.bulk_adaptive_resize(str(src), str(dst), 32,
                                               num_workers=2, **kw))
        trees.append(sorted(str(p.relative_to(dst))
                            for p in dst.rglob("*") if p.is_file()))
        np.testing.assert_allclose(read_nifti(str(dst / "a" / "x.nii.gz")),
                                   read_nifti(str(tmp_path / "t" / "a"
                                                  / "x.nii.gz")),
                                   rtol=0, atol=1e-4)
    assert counts == [2, 2] and trees[0] == trees[1]
    assert capsys.readouterr().out.count("resize failed") == 2


# --- the synthesis loop through the port's serve-llm ---

def test_client_closes_the_loop_with_the_ports_server(monkeypatch):
    """``OpenAIProtocolClient`` against ``cli serve-llm --preset tiny
    --device cpu`` on a thread: every synthesis operation gets a reply,
    and the text is what the server's own completion gives."""
    from u2tokenizer_torch import cli
    from u2tokenizer_torch.serve import serve_background

    tok = MockTokenizer()
    tok(" ".join(f"w{i}" for i in range(400)))
    args = cli.build_parser().parse_args(
        ["serve-llm", "--preset", "tiny", "--device", "cpu",
         "--max-new-tokens", "6", "--host", "127.0.0.1", "--port", "0"])
    lm = cli.build_llm_server(args, tokenizer=tok)
    monkeypatch.setenv("no_proxy", "*")  # the server is local
    server = serve_background(lm, port=0, transform=False)
    try:
        cfg = t_syn.LLMClientConfig(
            base_url=f"http://127.0.0.1:{server.server_address[1]}/v1",
            max_retries=2, max_tokens=6)
        client = t_syn.OpenAIProtocolClient(cfg)
        report = "the lungs are clear"
        out = t_syn.rewrite_report(client, report)
        assert isinstance(out, str) and out
        assert out == t_syn.split_thinking(client(
            f"{t_syn.rewrite_prompt}\n\nReport:\n{report}"))[1]
        assert isinstance(t_syn.translate_report(client, report), str)
        assert isinstance(t_syn.generate_qa_pairs(client, report, 2), list)
        thinking, answer = t_syn.refine_thinking(client, report, "q?", "",
                                                 report)
        assert isinstance(answer, str)
    finally:
        server.shutdown()
