"""The PyTorch port stands alone: it imports without jax, names nothing of
the JAX package, and its entry points refuse to run on a missing GPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "esn_ofdm_mimo_tpu_torch"
_PORT_FILES = sorted(p for p in PORT.rglob("*")
                     if p.suffix in (".py", ".cu", ".cuh")) + [
                         ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import esn_ofdm_mimo_tpu_torch as p\n"
            "import esn_ofdm_mimo_tpu_torch.parallel, "
            "esn_ofdm_mimo_tpu_torch.utils.convert, "
            "esn_ofdm_mimo_tpu_torch.ldpc.decode_cuda, "
            "esn_ofdm_mimo_tpu_torch.models.esn_cuda\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "assert not any(m == 'esn_ofdm_mimo_tpu' or "
            "m.startswith('esn_ofdm_mimo_tpu.') for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
    assert not re.search(r"^\s*(import|from)\s+esn_ofdm_mimo_tpu(\.|\s)",
                         text, re.M), path


def test_entry_point_without_cuda_raises():
    from esn_ofdm_mimo_tpu_torch.experiments.presets import mimo_4x8_cdl
    from esn_ofdm_mimo_tpu_torch.parallel import cdl_snr_point

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    keys = np.zeros((1, 1, 2), np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cdl_snr_point(mimo_4x8_cdl(), 12.0, keys, keys)


def test_presets_equal_the_jax_presets():
    import dataclasses

    from esn_ofdm_mimo_tpu.experiments import presets as jp
    from esn_ofdm_mimo_tpu_torch.experiments import presets as tp

    assert list(tp.PRESETS) == list(jp.PRESETS)
    for name in jp.PRESETS:
        for fast in (False, True):
            a = dataclasses.asdict(jp.get_preset(name, fast))
            b = dataclasses.asdict(tp.get_preset(name, fast))
            assert a == b, name


def test_chip_smoke_exits_nonzero_without_cuda(tmp_path):
    """Without a GPU (and in a directory holding only the script) the smoke
    run fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
