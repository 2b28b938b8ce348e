"""``kernels/build.py`` names each library by a hash of its source, every
header of ``csrc/`` and the flags, so an edited header rebuilds every
library that may include it. These tests need no ``nvcc``: they point
``CSRC`` and ``BUILD_DIR`` at a temporary directory and read the paths."""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "hopper.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "hopper.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_is_stable_and_in_the_build_dir(csrc, tmp_path):
    path = build.library_path("a")
    assert path == build.library_path("a")
    assert path.parent == tmp_path / "build"
    assert path.name.startswith("liba-") and path.suffix == ".so"
    assert build.library_path("a") != build.library_path("b")


@pytest.mark.parametrize("edit", ["header", "new header", "source", "header renamed"])
def test_library_path_changes_with_the_source_or_any_header(csrc, edit):
    before = {name: build.library_path(name) for name in ("a", "b")}
    if edit == "header":
        (csrc / "hopper.cuh").write_text("#pragma once\n// wgmma helpers\n")
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif edit == "header renamed":
        (csrc / "hopper.cuh").rename(csrc / "sm90.cuh")
    else:
        (csrc / "a.cu").write_text('#include "hopper.cuh"\nint a = 1;\n')
    after = {name: build.library_path(name) for name in ("a", "b")}
    assert after["a"] != before["a"]
    # a header may be included by any source: every library rebuilds
    assert (after["b"] != before["b"]) == (edit != "source")


def test_a_library_already_built_is_found_without_nvcc(csrc, monkeypatch):
    path = build.library_path("a")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    path.with_suffix(".log").write_text("ptxas info\n")

    def no_nvcc():
        raise AssertionError("nvcc called for a library already built")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_SECONDS", {})
    monkeypatch.setattr(build, "BUILD_LOG", {})
    assert build.compile_library("a") == path
    assert build.BUILD_LOG == {"a": "ptxas info\n"} and build.BUILD_SECONDS == {"a": 0.0}
    (csrc / "hopper.cuh").write_text("#pragma once\n// edited\n")
    with pytest.raises(AssertionError, match="nvcc called"):
        build.compile_library("a")
