"""ops/cuda/build.py's library names: a hash of the source, every header it
includes with quotes (theirs too) and the compiler flags, so that an edited
header rebuilds every library built from it and nothing else. Nothing is
compiled here (no nvcc): only the names are computed."""

import shutil

import pytest

from visualslam_tpu_torch.ops.cuda import build

HEADER = "jacobi_f32.cuh"
USERS = {"small_linalg", "triangulate"}     # the sources that include it


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build.py reads in place of the package's."""
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    monkeypatch.setattr(build, "CSRC", dst)
    return dst


def test_sources_are_the_file_and_its_headers():
    for name in build.SOURCES:
        files = build.sources(name)
        assert files[0] == build.CSRC / f"{name}.cu"
        assert all(f.exists() for f in files)
        assert (build.CSRC / HEADER in files) == (name in USERS)


def test_a_copy_of_the_sources_keeps_every_name(monkeypatch, tmp_path):
    """The name depends on the files' bytes, not on where they lie."""
    before = {n: build.library_path(n).name for n in build.SOURCES}
    shutil.copytree(build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    assert {n: build.library_path(n).name for n in build.SOURCES} == before


@pytest.mark.parametrize("edited", [HEADER, "small_linalg.cu"])
def test_editing_a_file_renames_the_libraries_built_from_it(csrc, edited):
    before = {n: build.library_path(n) for n in build.SOURCES}
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    users = USERS if edited == HEADER else {"small_linalg"}
    for n in build.SOURCES:
        assert (build.library_path(n) != before[n]) == (n in users), n


def test_a_header_included_by_a_header_is_hashed(csrc):
    (csrc / "inner.cuh").write_text("// one\n")
    header = csrc / HEADER
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert csrc / "inner.cuh" in build.sources("triangulate")
    before = build.library_path("triangulate")
    (csrc / "inner.cuh").write_text("// two\n")
    assert build.library_path("triangulate") != before
