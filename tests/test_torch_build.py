"""The port's kernel build (speakerguard_tpu_torch/ops/_build.py): a
library's name hashes its source and every shared header, so an edit to
either rebuilds it.  Nothing here needs nvcc or a card."""

import shutil

from speakerguard_tpu_torch.ops import _build


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "_build")
    names = {n: _build.library_path(n).name
             for n in ("gmm", "gmm_stats_fwd", "gmm_stats_bwd")}
    assert all(p.startswith(f"lib{n}-") and p.endswith(".so")
               for n, p in names.items())
    assert _build.library_path("gmm_stats_bwd") == (
        csrc / "_build" / names["gmm_stats_bwd"])

    header = csrc / "wgmma_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n).name for n in names}
    # every library's name moves with a header edit, whether or not its
    # source includes that header (the hash does not parse includes)
    assert all(after[n] != names[n] for n in names)

    src = csrc / "gmm_stats_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("gmm_stats_bwd").name != after[
        "gmm_stats_bwd"]
    assert _build.library_path("gmm_stats_fwd").name == after[
        "gmm_stats_fwd"]
