"""The port's kernel builder names each library by what it is built from.

``_build._target`` hashes a kernel's source, every shared ``csrc/*.cuh``
header and the nvcc flags into the library's file name, so an edited
header gives a new library and a stale one is never loaded.  This needs
no nvcc: it tests the name only, in a temporary source tree.

The wrappers' launch counter (``_build.count_launch``) is shared by rank
threads that launch at once: a stress test with more threads than cores
and a tiny switch interval checks that no increment is lost and that each
thread's own tally (``thread_launches``) holds only its launches.
"""

import os
import sys
import threading

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


def test_launch_counts_survive_concurrent_launches():
    def fake_kernel():
        pass

    fake_kernel.launches = 0
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 2000
    tallies = [None] * n_threads
    start = threading.Barrier(n_threads)

    def launcher(i):
        start.wait(timeout=30)
        before = _build.thread_launches().get("fake_kernel", 0)
        for _ in range(per_thread):
            _build.count_launch(fake_kernel)
        tallies[i] = _build.thread_launches()["fake_kernel"] - before

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launcher, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert fake_kernel.launches == n_threads * per_thread
    assert tallies == [per_thread] * n_threads
