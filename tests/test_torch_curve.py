"""The port's curve entry point: `run_cdl_curve` / `run_nbf_curve` with the
adaptive top-up, checkpoints and retry, the reporting functions and the CLI
(`esn_ofdm_mimo_tpu_torch.experiments.run`), on the CPU (device="cpu", so
the kernels' plain versions run) at tiny sizes.

Against the JAX package: `run_cdl_curve` on the tiny calibrated config of
tests/test_torch_slice.py (QC code, offset min-sum, ESN noise 0, JAX on a
one-device mesh so the batch-mode reservoir draw agrees) gives EQUAL BERs
and BP telemetry, calibrators within 1e-4 (float32 GD in two libraries);
`save_cdl_results` / `save_nbf_results` fed the same host results write
byte-identical CSV and text files and equal pickles.
"""
import ast
import dataclasses
import json
import pickle

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

import esn_ofdm_mimo_tpu  # noqa: F401
import __graft_entry__ as graft
from esn_ofdm_mimo_tpu.parallel import montecarlo as jmc
from esn_ofdm_mimo_tpu.utils import reporting as jrep
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.experiments import run as cli
from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
from esn_ofdm_mimo_tpu_torch.parallel import (nbf_snr_point, run_cdl_curve,
                                              run_nbf_curve)
from esn_ofdm_mimo_tpu_torch.utils import metrics as tmetrics
from esn_ofdm_mimo_tpu_torch.utils import reporting as trep
from esn_ofdm_mimo_tpu_torch.utils import rng
from esn_ofdm_mimo_tpu_torch.utils.checkpoint import SnrCheckpoint

# The suite runs in several worker processes at once. One intra-op thread
# per process keeps torch's many small CPU ops (the int64 RNG) from
# oversubscribing the cores, which slows such tests a hundredfold.
torch.set_num_threads(1)

G = 4


def _jax_cdl_cfg():
    cfg = graft._flagship_cfg(tiny=True)
    return dataclasses.replace(
        cfg, calib=dataclasses.replace(cfg.calib, enabled=True),
        ldpc=dataclasses.replace(cfg.ldpc, family="qc",
                                 algo="offset-minsum"),
        esn=dataclasses.replace(cfg.esn, noise=0.0), ebno_db=(12.0, 24.0))


def _port_cfg(cfg):
    sub = {f.name: getattr(tc, type(getattr(cfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
        if dataclasses.is_dataclass(getattr(cfg, f.name))}
    return dataclasses.replace(tc.SimConfig(), **{
        f.name: sub.get(f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def _cdl_cfg():
    return _port_cfg(_jax_cdl_cfg())


def _nbf_cfg(**kw):
    """tests/test_torch_nbf.py's tiny 2x2 block-fading config."""
    return tc.SimConfig(
        name="tiny",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40, noise=0.0),
        ldpc=tc.LdpcConfig(max_iter=20, decode_every=2, family="qc",
                           algo="offset-minsum"),
        ebno_db=(3.0, 12.0), **kw)


_KEYS = ("ber_uncoded", "ber_coded", "ldpc_avg_iters",
         "ldpc_unconverged_frac")


def _same_cdl_results(got, want, calib_atol=0.0):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["ebno_db"] == b["ebno_db"]
        for k in _KEYS:
            assert a[k] == b[k], (k, a[k], b[k])
        for d in b["calib"]:
            np.testing.assert_allclose(np.asarray(a["calib"][d]),
                                       np.asarray(b["calib"][d]),
                                       rtol=0, atol=calib_atol)


# ---- run_cdl_curve against the JAX package ---------------------------------

@pytest.fixture(scope="module")
def cdl_curves(tmp_path_factory):
    """(JAX curve, port curve without a checkpoint, port curve with one,
    the checkpoint directory): 12 blocks per SNR in rounds of 4 = 1
    calibration round + 2 decode rounds."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("trials",))
    want = jmc.run_cdl_curve(_jax_cdl_cfg(), 12, blocks_per_device=G,
                             mesh=mesh, progress=None)
    cfg = _cdl_cfg()
    plain = run_cdl_curve(cfg, 12, blocks_per_round=G, device="cpu",
                          progress=None)
    ckdir = tmp_path_factory.mktemp("ckpt")
    saved = run_cdl_curve(cfg, 12, blocks_per_round=G, device="cpu",
                          progress=None, checkpoint=SnrCheckpoint(str(ckdir)))
    return want, plain, saved, ckdir


def test_cdl_curve_equals_jax(cdl_curves):
    want, plain, _, _ = cdl_curves
    _same_cdl_results(plain, want, calib_atol=1e-4)
    assert 0 < plain[1]["ber_uncoded"]["mmse"] < plain[0]["ber_uncoded"]["mmse"]
    assert set(plain[0]) == set(want[0])


def test_cdl_curve_with_checkpoint_equals_jax_and_reloads(cdl_curves):
    want, plain, saved, ckdir = cdl_curves
    _same_cdl_results(saved, want, calib_atol=1e-4)
    _same_cdl_results(saved, plain)
    ck = SnrCheckpoint(str(ckdir))
    assert ck.has(0) and ck.has(1) and not ck.has(2)
    # the JAX package's pickle layout: its checkpoint class reads the files
    from esn_ofdm_mimo_tpu.utils.checkpoint import SnrCheckpoint as JaxCk
    assert JaxCk(str(ckdir)).load(1) == saved[1]
    # a run that finds every SNR point in the checkpoint simulates nothing
    calls = []
    orig = tmc.cdl_snr_point
    tmc.cdl_snr_point = lambda *a, **k: calls.append(a) or orig(*a, **k)
    try:
        again = run_cdl_curve(_cdl_cfg(), 12, blocks_per_round=G,
                              device="cpu", progress=None, checkpoint=ck)
    finally:
        tmc.cdl_snr_point = orig
    assert calls == []
    _same_cdl_results(again, saved)


def test_cdl_curve_resume_after_interruption(cdl_curves, tmp_path):
    _, plain, _, _ = cdl_curves
    ck = SnrCheckpoint(str(tmp_path))

    def stop_after_first(msg):
        if "EbNo=12 dB:" in msg:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run_cdl_curve(_cdl_cfg(), 12, blocks_per_round=G, device="cpu",
                      progress=stop_after_first, checkpoint=ck)
    assert ck.has(0) and not ck.has(1)
    msgs = []
    resumed = run_cdl_curve(_cdl_cfg(), 12, blocks_per_round=G, device="cpu",
                            progress=msgs.append, checkpoint=ck)
    _same_cdl_results(resumed, plain)
    assert not any("EbNo=12 dB" in m for m in msgs)     # loaded, not re-run
    assert any("EbNo=24 dB" in m for m in msgs)


def test_cdl_single_round_budget_is_bumped_loudly():
    msgs = []
    cfg = dataclasses.replace(_cdl_cfg(), ebno_db=(12.0,))
    one = run_cdl_curve(cfg, 2, blocks_per_round=2, device="cpu",
                        progress=msgs.append)
    assert any("single 2-block round" in m and "2 rounds" in m for m in msgs)
    two = run_cdl_curve(cfg, 4, blocks_per_round=2, device="cpu",
                        progress=None)
    _same_cdl_results(one, two)


# ---- the adaptive top-up ----------------------------------------------------

def test_cdl_adaptive_topup_continues_the_id_stream():
    """An unreachable target tops every SNR point up to the cap in whole
    rounds, and the decoded sample is the fixed-budget run's with the same
    decode ids: 4 blocks = ids 0-1 calibration + 2-3 decode, topped up to 6
    decoded blocks = decode ids 2-7 = the 8-block budget's decode rounds."""
    cfg = _cdl_cfg()
    msgs = []
    adapt = run_cdl_curve(cfg, 4, blocks_per_round=2, device="cpu",
                          progress=msgs.append, adaptive_min_errors=10 ** 9,
                          adaptive_max_blocks=7, rounds_per_call=1)
    lines = [m for m in msgs if "adaptive" in m]
    assert len(lines) == len(cfg.ebno_db)
    assert all("+4 blocks (6 decoded), failed codewords {" in m
               for m in lines), lines              # 7 is not a whole round
    fixed = run_cdl_curve(cfg, 8, blocks_per_round=2, device="cpu",
                          progress=None)
    for a, b in zip(adapt, fixed):
        assert a["ber_coded"] == b["ber_coded"]
        assert a["ldpc_avg_iters"] == b["ldpc_avg_iters"]
        assert a["ber_uncoded"] == b["ber_uncoded"]


def test_cdl_adaptive_stop_rule_and_its_progress_line():
    """A target the failed codewords miss at 24 dB but the uncoded bit
    errors meet: frames top up, and the line prints frame counts; with
    adaptive_on_uncoded nothing is added. With an unreachable target the
    uncoded rule's line names and prints bit errors."""
    cfg = dataclasses.replace(_cdl_cfg(), ebno_db=(24.0,))
    kw = dict(blocks_per_round=2, device="cpu", adaptive_max_blocks=4)
    msgs = []
    run_cdl_curve(cfg, 4, progress=msgs.append, adaptive_min_errors=40, **kw)
    line, = [m for m in msgs if "adaptive" in m]
    assert "failed codewords" in line and "bit errors" not in line
    frames = ast.literal_eval(line[line.index("{"):])
    assert min(frames.values()) < 40
    msgs = []
    run_cdl_curve(cfg, 4, progress=msgs.append, adaptive_min_errors=40,
                  adaptive_on_uncoded=True, **kw)
    assert not any("adaptive" in m for m in msgs), msgs
    msgs = []
    run_cdl_curve(cfg, 4, progress=msgs.append, adaptive_min_errors=10 ** 9,
                  adaptive_on_uncoded=True, **kw)
    line, = [m for m in msgs if "adaptive" in m]
    assert "bit errors" in line and "failed codewords" not in line
    bits = ast.literal_eval(line[line.index("{"):])
    assert min(bits.values()) >= 40 > min(frames.values())


def test_nbf_adaptive_topup_is_a_superset_of_the_fixed_budget():
    cfg = _nbf_cfg()
    base = run_nbf_curve(cfg, 4, blocks_per_round=2, device="cpu",
                         progress=None)
    msgs = []
    adapt = run_nbf_curve(cfg, 4, blocks_per_round=2, device="cpu",
                          progress=msgs.append, adaptive_min_errors=10 ** 9,
                          adaptive_max_blocks=9)
    assert sum("adaptive" in m for m in msgs) == len(cfg.ebno_db), msgs
    assert all("failed codewords" in m for m in msgs if "adaptive" in m)
    np.testing.assert_array_equal(base.n_blocks, 4)
    np.testing.assert_array_equal(adapt.n_blocks, 8)    # 9 is no whole round
    assert (adapt.total_info_bits == 2 * base.total_info_bits).all()
    fixed = run_nbf_curve(cfg, 8, blocks_per_round=2, device="cpu",
                          progress=None)
    for d in fixed.ber:
        np.testing.assert_array_equal(adapt.ber[d], fixed.ber[d])
        np.testing.assert_array_equal(adapt.ber_coded[d], fixed.ber_coded[d])
    np.testing.assert_array_equal(adapt.cond_hist, fixed.cond_hist)
    # a 1-error target is met inside the base budget at 3 dB
    msgs2 = []
    run_nbf_curve(cfg, 4, blocks_per_round=2, device="cpu",
                  progress=msgs2.append, adaptive_min_errors=1,
                  adaptive_max_blocks=8)
    assert not any("adaptive" in m and "EbNo=3 dB" in m for m in msgs2)


def test_nbf_adaptive_on_uncoded_prints_the_counter_it_stops_on():
    cfg = dataclasses.replace(_nbf_cfg(), ebno_db=(12.0,))
    msgs = []
    res = run_nbf_curve(cfg, 2, blocks_per_round=2, device="cpu",
                        progress=msgs.append, adaptive_min_errors=10 ** 9,
                        adaptive_max_blocks=4, adaptive_on_uncoded=True)
    line, = [m for m in msgs if "adaptive" in m]
    assert "+2 blocks (4 total), bit errors {" in line
    printed = ast.literal_eval(line[line.index("{"):])
    for d, v in printed.items():
        assert v == round(res.ber[d][0] * res.total_bits[0]), d
    # met at once: nothing added
    msgs = []
    sat = run_nbf_curve(cfg, 2, blocks_per_round=2, device="cpu",
                        progress=msgs.append, adaptive_min_errors=1,
                        adaptive_max_blocks=4, adaptive_on_uncoded=True)
    assert not any("adaptive" in m for m in msgs)
    np.testing.assert_array_equal(sat.n_blocks, 2)


def test_nbf_curve_checkpoint_resume_and_call_rounding(tmp_path):
    cfg = _nbf_cfg()
    ck = SnrCheckpoint(str(tmp_path))
    # 5 blocks in rounds of 1, calls of 2 rounds -> 3 calls = 6 blocks, as
    # the JAX package rounds up to whole dispatches
    full = run_nbf_curve(cfg, 5, blocks_per_round=1, device="cpu",
                         progress=None, rounds_per_call=2)
    np.testing.assert_array_equal(full.n_blocks, 6)

    def stop_after_first(msg):
        if "EbNo=3 dB done" in msg:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run_nbf_curve(cfg, 5, blocks_per_round=1, device="cpu",
                      progress=stop_after_first, rounds_per_call=2,
                      checkpoint=ck)
    assert ck.has(0) and not ck.has(1)
    resumed = run_nbf_curve(cfg, 5, blocks_per_round=1, device="cpu",
                            progress=None, rounds_per_call=2, checkpoint=ck)
    for d in full.ber:
        np.testing.assert_array_equal(resumed.ber[d], full.ber[d])
        np.testing.assert_array_equal(resumed.ber_coded[d], full.ber_coded[d])
    np.testing.assert_array_equal(resumed.capacity_per_sc,
                                  full.capacity_per_sc)
    # the curve's point is nbf_snr_point on the same keys
    keys = rng.block_keys(rng.prng_key(cfg.seed), 1, torch.arange(6))
    pt = nbf_snr_point(cfg, 12.0, keys.reshape(6, 1, 2), device="cpu")
    assert full.total_bits[1] == pt.total_bits
    for d, v in pt.bit_errors.items():
        assert full.ber[d][1] == v / pt.total_bits


def test_stale_checkpoint_is_resimulated(tmp_path, capsys):
    ck = SnrCheckpoint(str(tmp_path))
    with open(ck._file(0), "wb") as f:
        f.write(b"\x80\x04not a pickle")
    assert ck.has(0) and ck.load_or_none(0) is None
    assert "re-simulating" in capsys.readouterr().out
    ck.save(0, {"x": 1})
    assert ck.load_or_none(0) == {"x": 1}


# ---- retry ------------------------------------------------------------------

def test_call_with_retry():
    seen, msgs = [], []

    def flaky(x):
        seen.append(x)
        if len(seen) < 3:
            raise RuntimeError("transient")
        return x + 1

    assert tmc._call_with_retry(flaky, (4,), progress=msgs.append) == 5
    assert len(seen) == 3 and len(msgs) == 2 and "attempt 2" in msgs[1]
    seen.clear()

    def broken(x):
        seen.append(x)
        raise ValueError("a program error")

    with pytest.raises(ValueError):
        tmc._call_with_retry(broken, (1,))
    assert len(seen) == 1                               # never retried
    seen.clear()

    def down(x):
        seen.append(x)
        raise RuntimeError("still down")

    with pytest.raises(RuntimeError, match="still down"):
        tmc._call_with_retry(down, (1,), retries=2)
    assert len(seen) == 3
    assert tmc._NO_RETRY[:5] == jmc._NO_RETRY


# ---- metrics ----------------------------------------------------------------

def test_metrics_logger_records_and_nan_guard(tmp_path):
    path = tmp_path / "sub" / "events.jsonl"
    log = tmetrics.MetricsLogger(str(path), echo=False)
    rec = log.log("progress", msg="hello", n=3)
    log.close()
    assert set(rec) == {"t", "event", "msg", "n"}
    assert json.loads(path.read_text()) == rec
    bad = torch.tensor([1.0, float("nan")])
    tmetrics.check_finite("x", bad)                     # off: free
    with tmetrics.debug_nan_checks(True):
        tmetrics.check_finite("x", torch.ones(3))
        with pytest.raises(FloatingPointError, match="non-finite values in x"):
            tmetrics.check_finite("x", bad)
    tmetrics.check_finite("x", bad)                     # restored
    with tmetrics.profile_trace("region", trace_dir=str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert (tmp_path / "tr" / "region.trace.json").stat().st_size > 0


# ---- reporting --------------------------------------------------------------

def _files(d):
    return {p.name: p.read_bytes() for p in d.iterdir() if p.is_file()}


def test_save_cdl_results_equal_the_jax_files(cdl_curves, tmp_path,
                                             monkeypatch):
    want, plain, _, _ = cdl_curves
    monkeypatch.setattr(jrep, "_plt", lambda: None)
    monkeypatch.setattr(trep, "_plt", lambda: None)
    jrep.save_cdl_results(str(tmp_path / "jax"), _jax_cdl_cfg(), plain)
    trep.save_cdl_results(str(tmp_path / "port"), _cdl_cfg(), plain)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(a) == sorted(b) == [
        "LLR_calibration_params_EbNo12dB.txt",
        "LLR_calibration_params_EbNo24dB.txt", "results_ber.csv",
        "results_ber.pkl"]
    for name in a:
        if name.endswith(".pkl"):
            assert pickle.loads(a[name]) == pickle.loads(b[name])
        else:
            assert a[name] == b[name], name
    assert a["results_ber.csv"].splitlines()[0] == (
        b"EbNo(dB),ESN_uncoded,MMSE_uncoded,ESN_coded,MMSE_coded")


def test_save_nbf_results_equal_the_jax_files(tmp_path, monkeypatch):
    monkeypatch.setattr(jrep, "_plt", lambda: None)
    monkeypatch.setattr(trep, "_plt", lambda: None)
    cfg = dataclasses.replace(_nbf_cfg(), ebno_db=(12.0, 18.0))
    res = run_nbf_curve(cfg, 2, blocks_per_round=2, device="cpu",
                        progress=None)
    as_jax = jmc.CurveResult(**dataclasses.asdict(res))
    jrep.save_nbf_results(str(tmp_path / "jax"), cfg, as_jax)
    trep.save_nbf_results(str(tmp_path / "port"), cfg, res)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(a) == sorted(b) == ["channel_metrics_2x2.pkl",
                                      "results_ber.csv", "results_ber.pkl"]
    assert a["results_ber.csv"] == b["results_ber.csv"]
    for name in ("channel_metrics_2x2.pkl", "results_ber.pkl"):
        assert pickle.loads(a[name]) == pickle.loads(b[name])
    bundle = pickle.loads(b["results_ber.pkl"])
    assert bundle["meta"] == {"name": "tiny", "N": 32, "N_t": 2, "N_r": 2,
                              "reservoir": 40}
    h = np.zeros(50)
    h[10], h[20] = 3, 1
    from esn_ofdm_mimo_tpu_torch.pipelines.blockfading import COND_BINS
    assert (trep.cond_percentiles_from_hist(h, COND_BINS)
            == jrep.cond_percentiles_from_hist(h, COND_BINS))


def test_figures_are_written_where_matplotlib_is(tmp_path):
    if trep._plt() is None:
        pytest.skip("matplotlib is not installed")
    cfg = dataclasses.replace(_nbf_cfg(), ebno_db=(12.0,))
    res = run_nbf_curve(cfg, 2, blocks_per_round=2, device="cpu",
                        progress=None)
    trep.save_nbf_results(str(tmp_path), cfg, res)
    names = {p.name for p in tmp_path.iterdir()}
    assert {"BER_curves.png", "BER_preLDPC_2x2.png",
            "mimo_channel_rank_info.png"} <= names


# ---- the CLI ----------------------------------------------------------------

def test_cli_flags_equal_the_jax_cli():
    """Every flag of the JAX CLI, same name and default; one more:
    --device."""
    import argparse

    from esn_ofdm_mimo_tpu.experiments import run as jrun
    captured = {}

    class Stop(Exception):
        pass

    def grab(self, argv=None):
        captured["ap"] = self
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Stop):
            jrun.main(["--preset", "siso_nbf"])
    finally:
        argparse.ArgumentParser.parse_args = orig

    def table(ap):
        return {a.option_strings[0]: (a.default, a.type, a.choices, a.nargs,
                                      a.required)
                for a in ap._actions if a.option_strings[0] != "-h"}

    want, got = table(captured["ap"]), table(cli._parser())
    assert got.pop("--device") == ("cuda", None, None, None, False)
    assert got == want
    offset_help = next(a.help for a in cli._parser()._actions
                       if a.option_strings[0] == "--ldpc-minsum-offset")
    assert "0.625" in offset_help


def test_cli_nbf_preset_on_cpu(tmp_path):
    out = tmp_path / "nbf"
    cli.main(["--preset", "siso_nbf", "--fast", "--device", "cpu",
              "--blocks-per-snr", "2", "--blocks-per-device", "1",
              "--ebno-list", "6,18", "--outdir", str(out), "--resume",
              "--debug-nans"])
    names = {p.name for p in out.iterdir()}
    assert {"results_ber.csv", "results_ber.pkl", "channel_metrics_1x1.pkl",
            "events.jsonl", "ckpt"} <= names
    rows = (out / "results_ber.csv").read_text().splitlines()
    assert rows[0].startswith("EbNo(dB),esn_uncoded,esn_fixed_uncoded")
    assert [r.split(",")[0] for r in rows[1:]] == ["6.0", "18.0"]
    events = [json.loads(x) for x in
              (out / "events.jsonl").read_text().splitlines()]
    assert events[0]["event"] == "run_start"
    assert events[0]["preset"] == "siso_nbf" and events[0]["devices"] == 1
    assert events[-1]["event"] == "run_done"
    assert sum(e["event"] == "progress" for e in events) == 2
    # a second call resumes from the checkpoints and writes the same CSV
    first = (out / "results_ber.csv").read_bytes()
    cli.main(["--preset", "siso_nbf", "--fast", "--device", "cpu",
              "--blocks-per-snr", "2", "--blocks-per-device", "1",
              "--ebno-list", "6,18", "--outdir", str(out), "--resume"])
    assert (out / "results_ber.csv").read_bytes() == first
    events = [json.loads(x) for x in
              (out / "events.jsonl").read_text().splitlines()]
    assert sum(e["event"] == "progress" for e in events) == 2   # none new


def test_cli_cdl_preset_on_cpu(tmp_path):
    out = tmp_path / "cdl"
    cli.main(["--preset", "mimo_4x8_cdl", "--fast", "--device", "cpu",
              "--blocks-per-snr", "1", "--blocks-per-device", "1",
              "--ebno-list", "12", "--ldpc-minsum-offset", "0.5",
              "--outdir", str(out)])
    names = {p.name for p in out.iterdir()}
    assert {"results_ber.csv", "results_ber.pkl", "events.jsonl",
            "LLR_calibration_params_EbNo12dB.txt"} <= names
    rows = (out / "results_ber.csv").read_text().splitlines()
    assert len(rows) == 2
    ebno, esn_u, mmse_u, esn_c, mmse_c = (float(x)
                                          for x in rows[1].split(","))
    assert ebno == 12.0 and 0 < mmse_u < 0.5 and 0 < esn_u < 0.5
    cal = (out / "LLR_calibration_params_EbNo12dB.txt").read_text()
    assert cal.splitlines()[0] == "bit, a_esn, b_esn, a_mmse, b_mmse"
    assert len(cal.splitlines()) == 5
    msgs = [json.loads(x).get("msg", "") for x in
            (out / "events.jsonl").read_text().splitlines()]
    assert any("single 1-block round" in m for m in msgs)


@pytest.mark.parametrize("argv,what", [
    (["--preset", "siso_nbf", "--ldpc-family", "gallager"], "gallager"),
    (["--preset", "siso_nbf", "--ldpc-family", "pyldpc"], "pyldpc"),
    (["--preset", "siso_nbf", "--channel-kind", "awgn_flat"], "awgn_flat"),
    (["--preset", "siso_qpsk_awgn"], "awgn_flat"),
])
def test_cli_refuses_what_is_not_ported(argv, what, tmp_path):
    with pytest.raises(NotImplementedError, match=what):
        cli.main(argv + ["--device", "cpu", "--fast", "--outdir",
                         str(tmp_path)])
    assert not any(tmp_path.iterdir())              # refused before any run


def test_cli_refusals_uncoded_qam_bits_and_missing_gpu(tmp_path):
    cfg = dataclasses.replace(
        _nbf_cfg(), ldpc=dataclasses.replace(_nbf_cfg().ldpc, enabled=False))
    with pytest.raises(NotImplementedError, match="ldpc.enabled=False"):
        cli._check_ported(cfg)
    with pytest.raises(SystemExit):
        cli.main(["--preset", "siso_nbf", "--qam-bits", "3"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--preset", "siso_nbf", "--fast", "--outdir",
                      str(tmp_path)])
        assert not any(tmp_path.iterdir())
