"""The port's kernel build (``u2tokenizer_torch/ops/_build.py``) and the
sources' shared header, on the CPU: no ``nvcc`` runs here.

A library is named by the hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so that a changed header rebuilds every
library and an unchanged tree reuses what was built.
"""

import pytest

from u2tokenizer_torch.ops import _build

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
