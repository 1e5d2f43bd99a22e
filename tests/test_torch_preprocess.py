"""``cli preprocess`` and its work queue (``data/preprocess.py``) against
the JAX package on the CPU: input order, per-volume error isolation, the
stem-collision names and the printed summary equal JAX
``native.bulk_preprocess``'s; the arrays are within ``TOL`` of JAX
``U2VolumeTransform(use_native=False)`` and, where the JAX package's C++
loader is built, within its own 5e-2 and correlation 0.999
(``tests/test_native.py``) of JAX ``cli preprocess`` (known difference
19)."""

import argparse
import os

import numpy as np
import pytest

from u2tokenizer_torch import cli as t_cli
from u2tokenizer_torch.data import preprocess as t_pre
from u2tokenizer_torch.data.nifti import write_nifti
from u2tokenizer_torch.data.transforms import U2VolumeTransform as TVol
from u2tokenizer_tpu import cli as j_cli
from u2tokenizer_tpu import native as j_native
from u2tokenizer_tpu.data.transforms import U2VolumeTransform as JVol

pytestmark = pytest.mark.fast

# the port's fp32 ingest against the JAX package's float64 Python path
# (``tests/test_torch_transforms.py`` holds the same)
TOL = 1e-4
# the JAX package's C++ loader against its Python path (test_native.py)
NATIVE_TOL, NATIVE_CORR = 5e-2, 0.999
SIZES = dict(target=32, chunk_depth=8, num_chunks=4)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Five inputs over two directories: 'case' in both (a collision),
    'solo', a corrupt file and a missing one."""
    root = tmp_path_factory.mktemp("pre")
    rng = np.random.default_rng(0)
    paths = []
    for sub, name, shape in (("a", "case.nii.gz", (37, 49, 23)),
                             ("a", "solo.nii", (30, 26, 40)),
                             ("b", "case.nii.gz", (20, 50, 12))):
        os.makedirs(root / sub, exist_ok=True)
        write_nifti(str(root / sub / name),
                    rng.uniform(-1000, 400, shape).astype(np.int16))
        paths.append(str(root / sub / name))
    (root / "b" / "broken.nii.gz").write_bytes(b"\x1f\x8b not gzip")
    paths.insert(2, str(root / "b" / "broken.nii.gz"))
    paths.append(str(root / "b" / "missing.nii"))
    return paths


def _jax_bulk(paths, out_dir, monkeypatch):
    """JAX ``bulk_preprocess`` over its Python path."""
    monkeypatch.setattr(j_native, "native_available", lambda: False)
    return j_native.bulk_preprocess(
        paths, out_dir=out_dir, num_workers=3,
        fallback=JVol(data_type="validation", target_size=SIZES["target"],
                      chunk_depth=SIZES["chunk_depth"],
                      num_chunks=SIZES["num_chunks"], use_native=False),
        **SIZES)


@pytest.mark.parametrize("to_disk", [False, True])
def test_order_isolation_and_names_equal_jax(volumes, tmp_path, to_disk,
                                             monkeypatch):
    outs = {}
    for name in ("t", "j"):
        out_dir = str(tmp_path / name) if to_disk else None
        if name == "t":
            res = t_pre.bulk_preprocess(volumes, num_workers=2,
                                        out_dir=out_dir, device="cpu",
                                        **SIZES)
        else:
            res = _jax_bulk(volumes, out_dir, monkeypatch)
        outs[name] = res
        assert [r[0] for r in res] == volumes
        assert [r[2] is None for r in res] == [True, True, False, True,
                                               False]
        if to_disk:
            assert all(r[1] is None for r in res)
            assert sorted(os.listdir(out_dir)) == [
                "a__case.npy", "b__case.npy", "solo.npy"]
    for (_, a, ea), (_, b, eb) in zip(outs["t"], outs["j"]):
        if ea is not None:
            assert ea.split(":")[0] == eb.split(":")[0]
        elif to_disk:
            continue
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    if to_disk:
        for f in os.listdir(tmp_path / "t"):
            np.testing.assert_allclose(np.load(tmp_path / "t" / f),
                                       np.load(tmp_path / "j" / f),
                                       rtol=0, atol=TOL)


def test_collision_refused_as_jax(tmp_path, monkeypatch):
    paths = ["/x/a/v.nii", "/y/a/v.nii.gz", "/z/w.nii"]
    for fn in (lambda: t_pre.bulk_preprocess(paths, out_dir=str(tmp_path),
                                             device="cpu"),
               lambda: _jax_bulk(paths, str(tmp_path), monkeypatch)):
        with pytest.raises(ValueError, match="collision"):
            fn()
    assert t_pre.output_names(["/x/a/v.nii", "/y/b/v.nii.gz", "/w.npy"]) \
        == {"/x/a/v.nii": "a__v", "/y/b/v.nii.gz": "b__v", "/w.npy": "w"}


def test_cli_preprocess_equals_jax(volumes, tmp_path, capsys, monkeypatch):
    """``cli preprocess --device cpu`` over a directory and a file: the
    same printed lines and exit code as the JAX command on its Python
    path, every array within TOL of JAX ``U2VolumeTransform``; each array
    is also ``U2VolumeTransform`` of the port bit for bit."""
    inputs = [os.path.dirname(volumes[0]), volumes[2]]
    sizes = ["--target", "32", "--chunk-depth", "8", "--num-chunks", "4"]
    with pytest.raises(SystemExit) as e:
        t_cli.main(["preprocess", *inputs, "--out-dir", str(tmp_path / "t"),
                    "--workers", "2", "--device", "cpu", *sizes])
    assert e.value.code == 1
    port_out = capsys.readouterr().out
    monkeypatch.setattr(j_native, "native_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        j_cli.cmd_preprocess(argparse.Namespace(
            inputs=inputs, out_dir=str(tmp_path / "j"), target=32,
            chunk_depth=8, num_chunks=4, workers=2))
    assert e.value.code == 1
    assert port_out.replace(str(tmp_path / "t"), "OUT") == \
        capsys.readouterr().out.replace(str(tmp_path / "j"), "OUT")
    assert "2/3 volumes" in port_out and "FAILED" in port_out
    t = TVol(target_size=32, chunk_depth=8, num_chunks=4, device="cpu")
    j = JVol(target_size=32, chunk_depth=8, num_chunks=4, use_native=False)
    for i, name in ((0, "case"), (1, "solo")):
        got = np.load(tmp_path / "t" / f"{name}.npy")
        np.testing.assert_array_equal(got, t(volumes[i]).numpy())
        np.testing.assert_allclose(got, j(volumes[i]), rtol=0, atol=TOL)


def test_cli_preprocess_against_the_native_loader(volumes, tmp_path):
    """Known difference 19: the JAX command's default C++ loader."""
    if not j_native.native_available():
        pytest.skip("the JAX package's native loader is not built here")
    sizes = ["--target", "32", "--chunk-depth", "8", "--num-chunks", "4"]
    paths = [volumes[0], volumes[1]]
    t_cli.main(["preprocess", *paths, "--out-dir", str(tmp_path / "t"),
                "--device", "cpu", *sizes])
    j_cli.main(["preprocess", *paths, "--out-dir", str(tmp_path / "j"),
                *sizes])
    for f in ("case.npy", "solo.npy"):
        a, b = (np.load(tmp_path / d / f) for d in ("t", "j"))
        assert a.shape == b.shape == (4, 8, 32, 32)
        assert np.abs(a - b).max() < NATIVE_TOL
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > NATIVE_CORR


def test_preprocess_needs_a_gpu_unless_told(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pre.bulk_preprocess(["/none.nii"], out_dir=str(tmp_path))
