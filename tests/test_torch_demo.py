"""Attention capture, the attention PNG and ``cli demo`` of the port against
the JAX package, on the CPU at the tiny configuration.

* ``capture_attention_maps`` gives the JAX package's five first-layer maps
  (same keys and shapes, fp32, 1e-5) and ``spatial_salience`` of them,
  for the 'rma' and 'rope' attentions; capture leaves the image tokens as
  they are.
* ``render_attention_png`` writes an RGB PNG of ``png_layout``'s size that
  zlib decodes, whose heat panels are not constant (known difference 16:
  the port draws other pixels than matplotlib).
* ``cli demo`` in ``--question`` mode and in REPL mode prints the JAX
  CLI's text, both reading one HF checkpoint written from JAX parameters
  (greedy, bf16, as ``tests/test_torch_eval_cli.py`` holds ``eval``).
"""

import dataclasses
import io
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_u2tok_variants import _flat, _pair, _redraw, _tree
from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.config import U2ModelConfig as TCfg
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.eval import attention_viz as t_viz
from u2tokenizer_torch.models import hf_export as t_export
from u2tokenizer_torch.models.u2_model import U2CausalLM as TModel
from u2tokenizer_torch.utils.mock_tokenizer import MockTokenizer
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.eval import attention_viz as j_viz
from u2tokenizer_tpu.models.u2_model import U2CausalLM as JModel

pytestmark = pytest.mark.fast

TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = {"svr_spatial", "svr_temporal", "tta_self", "tta_cross_visual",
        "tta_cross_text"}


def _models(attn_type):
    jcfg = JCfg.tiny()
    jcfg = dataclasses.replace(jcfg, u2t=dataclasses.replace(
        jcfg.u2t, attn_type=attn_type))
    rs = np.random.RandomState(20)
    d, h, w = jcfg.vision.input_spatial
    images = rs.randn(2, jcfg.num_chunks, d, h, w).astype(np.float32)
    qids = rs.randint(3, jcfg.llm.vocab_size, (2, 6)).astype(np.int32)
    jm = JModel(jcfg, dtype=jnp.float32)
    tm = TModel(TCfg.from_dict(dataclasses.asdict(jcfg)),
                dtype=torch.float32, device="cpu")
    params = _pair(jm, tm, np.zeros((2, 24), np.int32), images, qids)
    return jm, tm, params, images, qids


@pytest.mark.parametrize("attn_type", ["rma", "rope"])
def test_capture_maps_match_jax(attn_type):
    jm, tm, params, images, qids = _models(attn_type)
    ref = j_viz.capture_attention_maps(jm, params, images, qids)
    maps = t_viz.capture_attention_maps(tm, images, qids)
    assert set(maps) == set(ref) == KEYS
    for key in KEYS:
        assert maps[key].dtype == np.float32
        assert maps[key].shape == ref[key].shape, key
        np.testing.assert_allclose(maps[key], ref[key], err_msg=key, **TOL)
        np.testing.assert_allclose(maps[key].sum(-1), 1.0, atol=1e-5)
    for grid in (None, (4, 2)):
        np.testing.assert_allclose(t_viz.spatial_salience(maps, grid),
                                   j_viz.spatial_salience(ref, grid), **TOL)
    assert t_viz.spatial_salience(maps, (4, 2)).shape == (2, 2, 4, 2)


def test_capture_leaves_the_image_tokens():
    _, tm, _, images, qids = _models("rma")
    x, q = torch.from_numpy(images), torch.from_numpy(qids).long()
    with torch.no_grad():
        plain = tm.encode_vision(x, q)
        captured = tm.encode_vision_with_attention(x, q)
    assert torch.equal(plain, captured)


def _decode_png(data: bytes):
    """(height, width, RGB rows) of an 8-bit RGB PNG, each row's filter
    byte checked to be 0."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return h, w, rows[:, 1:].reshape(h, w, 3)


def test_attention_png(tmp_path):
    _, tm, _, images, qids = _models("rma")
    maps = t_viz.capture_attention_maps(tm, images, qids)
    out = t_viz.render_attention_png(maps, images[0], str(tmp_path / "a.png"),
                                     grid_hw=(4, 2))
    h, w, rgb = _decode_png(open(out, "rb").read())
    assert (h, w) == t_viz.png_layout(2) == (3 * t_viz.PANEL + 4 * t_viz.GAP,
                                             4 * t_viz.PANEL + 5 * t_viz.GAP)
    p, g = t_viz.PANEL, t_viz.GAP
    panels = [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2), (1, 3)]
    for row, col in panels:
        y, x = g + row * (p + g), g + col * (p + g)
        tile = rgb[y:y + p, x:x + p].reshape(-1, 3)
        assert len(np.unique(tile, axis=0)) > 1, (row, col)
    for col in (0, 1):  # the heat strips
        y, x = g + 2 * (p + g), g + col * (p + g)
        strip = rgb[y:y + t_viz.STRIP, x:x + p].reshape(-1, 3)
        assert len(np.unique(strip, axis=0)) > 1, col


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A NIfTI volume and a tiny μ²Qwen3 HF checkpoint of JAX
    parameters."""
    root = tmp_path_factory.mktemp("demo")
    rs = np.random.default_rng(21)
    write_nifti(str(root / "ct.nii.gz"),
                rs.uniform(-1000, 400, (40, 48, 36)).astype(np.float32))
    jcfg = JCfg.tiny()
    d, h, w = jcfg.vision.input_spatial
    params = jax.jit(JModel(jcfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 24), jnp.int32),
        jnp.zeros((1, jcfg.num_chunks, d, h, w)), jnp.zeros((1, 6),
                                                             jnp.int32))
    ckpt = root / "ckpt"
    t_export.save_hf_checkpoint(str(ckpt), _tree(_redraw(_flat(params), 7)),
                                TCfg.tiny())
    return root, str(ckpt)


def _demo_argv(files, *extra):
    root, ckpt = files
    return ["demo", "--tiny", "--checkpoint", ckpt, "--tokenizer", "mock",
            "--image", str(root / "ct.nii.gz"), "--max-length", "64",
            "--max-new-tokens", "6", *extra]


def _tokenizer():
    """The port's tokenizer for a run held against the JAX CLI's: a
    ``MockTokenizer`` numbers words as it first meets them, and the JAX
    demo encodes a "warmup" prompt for its model's init before any
    question."""
    tok = MockTokenizer()
    tok.encode(tok.apply_chat_template([{"role": "user",
                                         "content": "warmup"}]))
    return tok


def _jax_demo(argv, capsys):
    args = j_cli.build_parser().parse_args(argv)
    args.fn(args)
    return capsys.readouterr().out.splitlines()


def test_cli_demo_question_matches_jax(files, capsys, tmp_path):
    argv = _demo_argv(files, "--question", "Describe the findings")
    png = str(tmp_path / "maps.png")
    args = t_cli.build_parser().parse_args(
        argv + ["--device", "cpu", "--attention", png])
    answers = args.fn(args, tokenizer=_tokenizer())
    port = capsys.readouterr().out.splitlines()
    assert port == answers and len(answers) == 1 and answers[0]
    assert _jax_demo(argv, capsys) == port
    h, w, _ = _decode_png(open(png, "rb").read())
    assert (h, w) == t_viz.png_layout(TCfg.tiny().num_chunks)


def test_cli_demo_repl_matches_jax(files, capsys, monkeypatch):
    questions = "Describe the findings\nIs there an effusion\n\n"
    argv = _demo_argv(files)
    monkeypatch.setattr("sys.stdin", io.StringIO(questions))
    args = t_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    answers = args.fn(args, tokenizer=_tokenizer())
    port = capsys.readouterr().out.splitlines()  # input()'s "> " prompts
    assert len(answers) == 2 and port[:2] == ["> " + a for a in answers]
    monkeypatch.setattr("sys.stdin", io.StringIO(questions))
    assert _jax_demo(argv, capsys) == port
