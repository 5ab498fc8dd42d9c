"""The kernel libraries are named by what they are built from (ops/_build.py),
so an edited shared header rebuilds every source; no nvcc is needed here."""

import shutil

from eilev_tpu_torch.ops import _build


def test_library_name_follows_the_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the sources share a header"
    names = {src.name: _build.library_path(src.name, csrc) for src in csrc.glob("*.cu")}
    assert names == {src.name: _build.library_path(src.name) for src in _build.CSRC.glob("*.cu")}

    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    for src, before in names.items():
        after = _build.library_path(src, csrc)
        assert after != before and after.parent == before.parent
        assert after.name.rsplit("_", 1)[0] == before.name.rsplit("_", 1)[0] == src[:-3]


def test_library_name_follows_the_source(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build.library_path("fused_mlp.cu", csrc)
    (csrc / "fused_mlp.cu").write_bytes((csrc / "fused_mlp.cu").read_bytes() + b" ")
    assert _build.library_path("fused_mlp.cu", csrc) != before
    assert _build.library_path("packed_attention.cu", csrc) == _build.library_path("packed_attention.cu")
