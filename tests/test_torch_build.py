"""``repro_torch.kernels.build``: a build's file name carries a hash of the
CUDA source, every shared header in ``csrc/`` and the flags, so an edit to
any of them builds anew (nothing is compiled here: the host has no nvcc)."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build as KB  # noqa: E402


def test_the_port_has_its_sources_and_the_shared_header():
    names = {p.name for p in KB.sources()}
    assert {"flash_attention.cu", "flash_decode.cu", "ssd_scan.cu"} <= names
    assert [p.name for p in KB.headers()] == ["hopper.cuh"]
    assert all('#include "hopper.cuh"' in (KB.CSRC / n).read_text()
               for n in ("flash_attention.cu", "flash_decode.cu", "ssd_scan.cu"))


@pytest.mark.parametrize("edit", ["source", "header", "flags"])
def test_an_edit_to_a_source_a_header_or_the_flags_changes_the_tag(tmp_path, monkeypatch, edit):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n__global__ void k() {}\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    (tmp_path / "other.cu").write_text("__global__ void o() {}\n")
    monkeypatch.setattr(KB, "CSRC", tmp_path)
    source = tmp_path / "k.cu"
    before = KB.tag(source)
    assert KB.tag(source) == before and KB.tag(tmp_path / "other.cu") != before
    if edit == "source":
        source.write_text(source.read_text() + "// edited\n")
    elif edit == "header":
        (tmp_path / "h.cuh").write_text("#pragma once\n#define X 1\n")
    else:
        monkeypatch.setattr(KB, "NVCC_FLAGS", KB.NVCC_FLAGS + ("-lineinfo",))
    assert KB.tag(source) != before
