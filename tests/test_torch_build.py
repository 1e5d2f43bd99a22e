"""The port's kernel build (``u2tokenizer_torch/ops/_build.py``) and the
sources' shared header, on the CPU: no ``nvcc`` runs here.

A library is named by the hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so that a changed header rebuilds every
library and an unchanged tree reuses what was built.
"""

import re

import pytest

from u2tokenizer_torch.ops import _build
from u2tokenizer_torch.ops import flash_attention as fa

pytestmark = pytest.mark.fast


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree of two kernels and one shared header, in place of
    ``csrc/``."""
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\nint b;\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_target_follows_headers_not_other_sources(csrc):
    a = csrc / "a.cu"
    before = _build._target(a)
    assert before == _build._target(a)  # stable for an unchanged tree
    assert before.parent == csrc / "build" and before.name.startswith("a-")

    (csrc / "b.cu").write_text('#include "shared.cuh"\nint b2;\n')
    assert _build._target(a) == before  # another kernel's source

    (csrc / "shared.cuh").write_text("#pragma once\n// changed\n")
    changed = _build._target(a)
    assert changed != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._target(a) not in (before, changed)  # a new header

    a.write_text('#include "shared.cuh"\nint a2;\n')
    assert _build._target(a) not in (before, changed)


def test_target_follows_flags(csrc, monkeypatch):
    before = _build._target(csrc / "a.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._target(csrc / "a.cu") != before


def test_build_without_nvcc_raises(csrc, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_flash_sources_share_the_hopper_header():
    """K1/K2 and K4b/K4c build on the one shared header."""
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        assert '#include "hopper.cuh"' in (_build.CSRC / name).read_text()


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd.cu"])
def test_flash_switches_instantiate_the_wrappers_head_dims(source):
    """The launch switch of K1/K2 (flash_fwd.cu) and of K4a-c
    (flash_bwd.cu) instantiates every head dim the wrappers let through,
    the tiny configs' 16 and 32 among them, and no other."""
    text = (_build.CSRC / source).read_text()
    cases = tuple(sorted(int(d) for d in re.findall(r"case (\d+):", text)))
    assert cases == fa.FWD_HEAD_DIMS == fa.BWD_HEAD_DIMS
    assert {16, 32} <= set(cases)
    assert set(fa.launches) == {f"{name}_d{d}" for d in cases
                                for name in fa.KERNELS + fa.BWD_KERNELS}


def test_decode_switch_instantiates_the_wrappers_head_dims():
    """K3's head-dim switch (csrc/decode_attention.cu ``dispatch``)
    instantiates every head dim its wrapper lets through, the tiny
    configs' 32 among them, and no other."""
    from u2tokenizer_torch.ops import decode_attention as da

    text = (_build.CSRC / "decode_attention.cu").read_text()
    switch = text[text.index("switch (d)"):]
    switch = switch[:switch.index("}")]
    cases = tuple(sorted(int(d) for d in re.findall(r"case (\d+):", switch)))
    assert cases == da.HEAD_DIMS
    assert 32 in cases
