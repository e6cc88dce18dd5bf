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
                         ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                         ROOT / "tools" / "bench_micro_torch.py"]


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import esn_ofdm_mimo_tpu_torch as p\n"
            "import esn_ofdm_mimo_tpu_torch.parallel, "
            "esn_ofdm_mimo_tpu_torch.utils.convert, "
            "esn_ofdm_mimo_tpu_torch.ldpc.decode_cuda, "
            "esn_ofdm_mimo_tpu_torch.models.esn_cuda, "
            "esn_ofdm_mimo_tpu_torch.models.esn_states_cuda, "
            "esn_ofdm_mimo_tpu_torch.ops.analytics, "
            "esn_ofdm_mimo_tpu_torch.pipelines.blockfading, "
            "esn_ofdm_mimo_tpu_torch.experiments.run, "
            "esn_ofdm_mimo_tpu_torch.utils.checkpoint, "
            "esn_ofdm_mimo_tpu_torch.utils.metrics, "
            "esn_ofdm_mimo_tpu_torch.utils.reporting, "
            "esn_ofdm_mimo_tpu_torch.ldpc.nr, "
            "esn_ofdm_mimo_tpu_torch.ops.linalg, "
            "esn_ofdm_mimo_tpu_torch.sm1, "
            "esn_ofdm_mimo_tpu_torch.models.elm, "
            "esn_ofdm_mimo_tpu_torch.models.zoo, "
            "esn_ofdm_mimo_tpu_torch.models.classifiers, "
            "esn_ofdm_mimo_tpu_torch.pipelines.classification, "
            "esn_ofdm_mimo_tpu_torch.experiments.classify, "
            "esn_ofdm_mimo_tpu_torch.pipelines.zoo2x2, "
            "esn_ofdm_mimo_tpu_torch.experiments.compare2x2, "
            "esn_ofdm_mimo_tpu_torch.parallel.mesh, "
            "esn_ofdm_mimo_tpu_torch.parallel.seqshard, "
            "esn_ofdm_mimo_tpu_torch.utils.model_io, "
            "esn_ofdm_mimo_tpu_torch.experiments.scaling, "
            "esn_ofdm_mimo_tpu_torch.utils.flops\n"
            "import runpy\n"
            "runpy.run_path('tools/bench_micro_torch.py', run_name='tool')\n"
            "runpy.run_path('bench_torch.py', run_name='bench_torch')\n"
            "assert 'bench' not in sys.modules\n"
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


@pytest.mark.parametrize("builder", ["make_sharded_nbf_step",
                                     "make_sharded_nbf_scan_step",
                                     "make_fused_nbf_grid"])
def test_nbf_builders_without_cuda_raise(builder):
    """The NBF builders run on the card unless device="cpu" is asked for."""
    from esn_ofdm_mimo_tpu_torch.experiments.presets import mimo_4x8_nbf
    from esn_ofdm_mimo_tpu_torch.parallel import montecarlo

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    make = getattr(montecarlo, builder)
    args = (4, 1) if builder == "make_fused_nbf_grid" else ()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(mimo_4x8_nbf(), *args)
    assert callable(make(mimo_4x8_nbf(), *args, device="cpu"))


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
