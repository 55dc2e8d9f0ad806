"""The kernel builder's cache key, on the CPU: `kernels.library_path` must
change when a source's header changes, so an edited shared `*.cuh` is
rebuilt and a stale library never loaded (nothing is compiled here)."""

from mdi_llm_tpu_torch import kernels


def test_library_path_tracks_sources_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\nint x;\n')
    (tmp_path / "tile.cuh").write_text("int tile = 1;\n")
    first = kernels.library_path("k")
    assert first == kernels.library_path("k"), "the same files give the same path"
    (tmp_path / "tile.cuh").write_text("int tile = 2;\n")
    second = kernels.library_path("k")
    assert second != first, "editing a header changes the library's path"
    (tmp_path / "other.cuh").write_text("int other;\n")
    third = kernels.library_path("k")
    assert third not in (first, second), "a new header changes it too"
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\nint y;\n')
    assert kernels.library_path("k") not in (first, second, third)
    assert third.parent == kernels.BUILD_DIR and third.name.startswith("libk-")
