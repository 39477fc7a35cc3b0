"""The build cache key of the port's CUDA kernels (kernels.library_path).

A library is reused while its key is unchanged, so the key must cover
every byte that goes into the build: the source, each shared header under
csrc/ (`*.cuh`, which the sources include), and the nvcc flags.  These
run on a temporary csrc/ and need no nvcc.
"""
import pytest

from tf_operator_tpu_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path / "csrc"
    root.mkdir()
    (root / "k.cu").write_text('#include "tiles.cuh"\nint k() { return 1; }\n')
    (root / "tiles.cuh").write_text("// tiles v1\n")
    monkeypatch.setattr(kernels, "CSRC", root)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    return root


def test_key_is_stable_and_under_the_build_dir(csrc):
    path = kernels.library_path("k")
    assert path == kernels.library_path("k")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("k-") and path.suffix == ".so"


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_editing_what_the_build_reads_changes_the_key(csrc, edit):
    before = kernels.library_path("k")
    if edit == "header":
        (csrc / "tiles.cuh").write_text("// tiles v2\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// another shared header\n")
    else:
        (csrc / "k.cu").write_text('#include "tiles.cuh"\nint k() { return 2; }\n')
    assert kernels.library_path("k") != before


def test_renaming_a_header_changes_the_key(csrc):
    before = kernels.library_path("k")
    (csrc / "tiles.cuh").rename(csrc / "tiles2.cuh")
    assert kernels.library_path("k") != before


def test_flags_change_the_key(csrc, monkeypatch):
    before = kernels.library_path("k")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels.library_path("k") != before


def test_build_all_reuses_a_library_under_the_current_key(csrc):
    """An existing library under the current key is not rebuilt (nothing
    calls nvcc, which this machine may lack); after a header edit the key
    names a library that does not exist yet."""
    lib = kernels.library_path("k")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert kernels.build_all(("k",)) == {}
    (csrc / "tiles.cuh").write_text("// tiles v2\n")
    assert not kernels.library_path("k").exists()


def test_the_port_sources_include_the_shared_header():
    """The three sources with tensor-core kernels include mma_tiles.cuh,
    so its edits must rebuild them: it is under csrc/ and ends in .cuh."""
    header = kernels.CSRC / "mma_tiles.cuh"
    assert header.exists()
    for name in ("flash_attention", "paged_attention", "ring_flash"):
        assert '#include "mma_tiles.cuh"' in (
            kernels.CSRC / f"{name}.cu").read_text()
