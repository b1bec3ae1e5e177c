"""The port's kernel builder names each library by what it is built from.

``_build._target`` hashes a kernel's source, every shared ``csrc/*.cuh``
header and the nvcc flags into the library's file name, so an edited
header gives a new library and a stale one is never loaded.  This needs
no nvcc: it tests the name only, in a temporary source tree.
"""

import os

import pytest

from zhpe_ompi_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return 0; }\n')
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(src / "_build"))
    return src


def test_unchanged_sources_keep_the_library_name(csrc):
    src, first = _build._target("kern")
    assert src == os.path.join(str(csrc), "kern.cu")
    assert os.path.dirname(first) == str(csrc / "_build")
    assert _build._target("kern")[1] == first


@pytest.mark.parametrize("edit", ["source", "header", "new header"])
def test_an_edit_renames_the_library(csrc, edit):
    before = _build._target("kern")[1]
    if edit == "source":
        (csrc / "kern.cu").write_text('extern "C" int f() { return 1; }\n')
    elif edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\n#define TILE 128\n")
    else:
        (csrc / "more.cuh").write_text("#pragma once\n")
    after = _build._target("kern")[1]
    assert after != before
    assert os.path.basename(after).startswith("libkern-")


def test_the_flags_are_part_of_the_name(csrc, monkeypatch):
    before = _build._target("kern")[1]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._target("kern")[1] != before
