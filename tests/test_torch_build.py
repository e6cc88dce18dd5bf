"""utils/build.py without the CUDA toolkit: nvcc is stubbed."""
from __future__ import annotations

import pytest

from esn_ofdm_mimo_tpu_torch.utils import build


def test_missing_source_raises_before_any_nvcc_starts(monkeypatch, tmp_path):
    started = []
    monkeypatch.setattr(build, "BUILD", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen",
                        lambda *a, **k: started.append(a) or pytest.fail(
                            "an nvcc was started"))
    with pytest.raises(FileNotFoundError):
        build.build_all(("threefry", "no_such_kernel"))
    assert started == []


def test_built_libraries_are_reused(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD", tmp_path)
    monkeypatch.setattr(build.subprocess, "Popen",
                        lambda *a, **k: pytest.fail("an nvcc was started"))
    build.lib_path("threefry").touch()
    assert build.build_all(("threefry",)) == {"threefry": 0.0}
