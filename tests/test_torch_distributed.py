"""The port over several processes: `torch.distributed` with gloo on
localhost (each rank a process of its own, a free port, a timeout of its
own), on the CPU (device="cpu": the kernels' plain versions).

  * run_nbf_curve and run_cdl_curve over 2 ranks (2 blocks a rank a round)
    in rng_mode "block" equal one process's curves (4 blocks a round) bit
    for bit, every rank returning the same result; in rng_mode "batch"
    they equal the JAX package's curves on trials_mesh(2) (2 blocks a
    device) at the bands of test_torch_curve.py (CDL: BERs and BP telemetry
    equal, calibrators within 1e-4) and test_torch_nbf.py (NBF: classical
    uncoded BER equal, ESN uncoded within 1% + 10 bits), the coded BER
    within two codewords' info bits (tests/test_montecarlo.py's band: at
    3 dB BP stops unconverged on bits that LLRs a few ulp apart move);
  * sharded_fir and overlap_save_scan over 2 and 4 ranks against their
    unsharded results and the JAX package's (tests/test_seqshard.py:13-61):
    the FIR within 1e-6 of the port's unsharded one and 1e-4 of JAX's, the
    scan exact on rank 0's shard (1e-5) with a median error below 1e-3
    elsewhere, and within 1e-5 of the JAX package's sharded scan;
  * the scaling CLI at one gloo rank writes --out.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import esn_ofdm_mimo_tpu  # noqa: F401
import __graft_entry__ as graft
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.ops.channel import apply_fir_channel as j_fir
from esn_ofdm_mimo_tpu.parallel import montecarlo as jmc
from esn_ofdm_mimo_tpu.utils.rng import block_keys as j_block_keys
from esn_ofdm_mimo_tpu.parallel.seqshard import (
    overlap_save_scan as j_scan_sharded, sharded_fir as j_sharded_fir)
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.ldpc import make_code
from esn_ofdm_mimo_tpu_torch.ops import apply_fir_channel
from esn_ofdm_mimo_tpu_torch.parallel import (
    TrialsMesh, run_cdl_curve, run_nbf_curve, trials_mesh)
from esn_ofdm_mimo_tpu_torch.parallel.seqshard import (overlap_save_scan,
                                                       sharded_fir)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One rank: reads the configurations and inputs from <out>/inputs.pkl,
# pickles its results to <out>/rank<r>.pkl.
_WORKER = textwrap.dedent("""
    import os, pickle, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from esn_ofdm_mimo_tpu_torch.parallel import (
        maybe_init_distributed, run_cdl_curve, run_nbf_curve, trials_mesh)
    from esn_ofdm_mimo_tpu_torch.parallel.seqshard import (
        overlap_save_scan, sharded_fir)
    out, what = sys.argv[1], sys.argv[2]
    with open(os.path.join(out, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    assert maybe_init_distributed("cpu")
    mesh, r, W = trials_mesh(), dist.get_rank(), dist.get_world_size()
    res = {}
    if what == "curves":
        for mode in ("block", "batch"):
            res["nbf", mode] = run_nbf_curve(
                inp["nbf", mode], 8, blocks_per_round=2, device="cpu",
                progress=None, mesh=mesh)
            res["cdl", mode] = run_cdl_curve(
                inp["cdl", mode], 12, blocks_per_round=2, device="cpu",
                progress=None, mesh=mesh)
    else:
        taps, x, W_s, xs, warmup = inp["seq"]
        n = x.shape[-1] // W
        res["fir"] = sharded_fir(torch.as_tensor(taps),
                                 torch.as_tensor(x[:, r * n:(r + 1) * n]),
                                 mesh.group).numpy()
        Wt = torch.as_tensor(W_s).T

        def step(state, x_t):
            new = torch.tanh(state @ Wt + x_t)
            return new, new

        n = xs.shape[0] // W
        res["scan"] = overlap_save_scan(
            step, torch.zeros(W_s.shape[0]),
            torch.as_tensor(xs[r * n:(r + 1) * n]), warmup,
            mesh.group).numpy()
    with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")


def _nbf_cfg(mode):
    """test_torch_nbf.py's tiny 2x2 block-fading config."""
    return tc.SimConfig(
        name="tiny",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40, noise=0.0, rng_mode=mode),
        ldpc=tc.LdpcConfig(max_iter=20, decode_every=2, family="qc",
                           algo="offset-minsum"),
        ebno_db=(3.0, 12.0))


def _jax_cdl_cfg(mode="batch"):
    """test_torch_curve.py's tiny calibrated config."""
    cfg = graft._flagship_cfg(tiny=True)
    return dataclasses.replace(
        cfg, calib=dataclasses.replace(cfg.calib, enabled=True),
        ldpc=dataclasses.replace(cfg.ldpc, family="qc",
                                 algo="offset-minsum"),
        esn=dataclasses.replace(cfg.esn, noise=0.0, rng_mode=mode),
        ebno_db=(12.0, 24.0))


def _convert(cfg, mod):
    """A SimConfig in the config classes of `mod` (either package)."""
    sub = {f.name: getattr(mod, type(getattr(cfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
        if dataclasses.is_dataclass(getattr(cfg, f.name))}
    return dataclasses.replace(mod.SimConfig(), **{
        f.name: sub.get(f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def _seq_inputs():
    """tests/test_seqshard.py's inputs: the FIR's taps and signal, the
    scan's weight, inputs and warmup."""
    r = np.random.default_rng(0)
    n_rx, n_tx, isi, T = 2, 2, 8, 64 * 8
    taps = (r.standard_normal((n_rx, n_tx, isi)) + 1j
            * r.standard_normal((n_rx, n_tx, isi))).astype(np.complex64)
    x = (r.standard_normal((n_tx, T))
         + 1j * r.standard_normal((n_tx, T))).astype(np.complex64)
    r = np.random.default_rng(1)
    n, warmup = 16, 24
    W = r.standard_normal((n, n)).astype(np.float32)
    W *= 0.7 / np.max(np.abs(np.linalg.eigvals(W)))
    xs = r.standard_normal((T, n)).astype(np.float32)
    return taps, x, W, xs, warmup


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world: int, what: str, out, timeout: float) -> list:
    """Run `world` gloo ranks of the worker; their result dicts."""
    with open(os.path.join(out, "inputs.pkl"), "wb") as f:
        pickle.dump({**{("nbf", m): _nbf_cfg(m) for m in ("block", "batch")},
                     **{("cdl", m): _convert(_jax_cdl_cfg(m), tc)
                        for m in ("block", "batch")},
                     "seq": _seq_inputs()}, f)
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(out), what],
        cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e[-3000:]
    out_r = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            out_r.append(pickle.load(f))
    return out_r


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _launch(2, "curves", tmp_path_factory.mktemp("curves"), 240)


def _same_curve(a, b):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), field.name
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=field.name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=field.name)


def test_block_mode_curves_over_two_ranks_equal_one_process(two_ranks):
    one_nbf = run_nbf_curve(_nbf_cfg("block"), 8, blocks_per_round=4,
                            device="cpu", progress=None)
    one_cdl = run_cdl_curve(_convert(_jax_cdl_cfg("block"), tc), 12,
                            blocks_per_round=4, device="cpu", progress=None)
    for res in two_ranks:
        _same_curve(res["nbf", "block"], one_nbf)
        assert res["cdl", "block"] == one_cdl
    assert one_nbf.n_blocks.tolist() == [8, 8]
    # without a process group the layout is one rank and no collective
    assert trials_mesh() == TrialsMesh(1, 0, None)


def test_batch_mode_curves_over_two_ranks_equal_jax(two_ranks):
    mesh = Mesh(np.array(jax.devices()[:2]), ("trials",))
    want_cdl = jmc.run_cdl_curve(_jax_cdl_cfg(), 12, blocks_per_device=2,
                                 mesh=mesh, progress=None)
    for res in two_ranks:
        got = res["cdl", "batch"]
        for a, b in zip(got, want_cdl):
            for k in ("ber_uncoded", "ber_coded", "ldpc_avg_iters",
                      "ldpc_unconverged_frac"):
                assert a[k] == b[k], (k, a[k], b[k])
            for d in b["calib"]:
                np.testing.assert_allclose(np.asarray(a["calib"][d]),
                                           np.asarray(b["calib"][d]),
                                           rtol=0, atol=1e-4)
    # the JAX curve's per-SNR stream (rounds of 4 global block ids, 2 a
    # device), through its sharded step
    cfg = _nbf_cfg("batch")
    jcfg = _convert(cfg, jc)
    step, root, acc = jmc.make_sharded_nbf_step(jcfg, mesh), \
        jax.random.PRNGKey(jcfg.seed), []
    for jj, ebno in enumerate(jcfg.ebno_db):
        rounds = [jax.device_get(step(jnp.float32(ebno), j_block_keys(
            root, jj, jnp.arange(4 * r, 4 * r + 4, dtype=jnp.uint32))))
            for r in range(2)]
        acc.append(jax.tree.map(lambda x, y: np.asarray(x) + np.asarray(y),
                                *rounds))
    want = jmc.assemble_curve(jcfg, np.asarray(jcfg.ebno_db, np.float32), acc)
    for res in two_ranks:
        got = res["nbf", "batch"]
        np.testing.assert_array_equal(got.total_bits, want.total_bits)
        np.testing.assert_array_equal(got.n_blocks, want.n_blocks)
        bits, info = got.total_bits, got.total_info_bits
        k_info = make_code(cfg.ldpc, 32 * 4).k
        for d in want.ber:
            g, w = got.ber[d] * bits, want.ber[d] * bits
            band = 0.01 * w + 10 if d.startswith("esn") else 0.5
            assert np.all(np.abs(g - w) <= band), (d, g, w)
            g, w = got.ber_coded[d] * info, want.ber_coded[d] * info
            assert np.all(np.abs(g - w) <= 2 * k_info), (d, g, w)
        np.testing.assert_array_equal(got.cond_hist, want.cond_hist)
        np.testing.assert_allclose(got.capacity_per_sc, want.capacity_per_sc,
                                   rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_seqshard_over_ranks(world, tmp_path):
    taps, x, W, xs, warmup = _seq_inputs()
    parts = _launch(world, "seqshard", tmp_path, 120)
    fir = np.concatenate([p["fir"] for p in parts], axis=-1)
    scan = np.concatenate([p["scan"] for p in parts], axis=0)
    # the FIR: the port's unsharded filter, and the JAX package's
    whole = apply_fir_channel(torch.as_tensor(taps), torch.as_tensor(x))
    np.testing.assert_allclose(fir, whole.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        fir, np.asarray(j_fir(jnp.asarray(taps), jnp.asarray(x))),
        rtol=1e-4, atol=1e-4)
    # one rank: sharded_fir without a group is the filter
    np.testing.assert_array_equal(
        sharded_fir(torch.as_tensor(taps), torch.as_tensor(x)).numpy(),
        whole.numpy())
    # the scan: exact on the first shard, echo-state close after the warmup
    Wt = torch.as_tensor(W).T

    def step(state, x_t):
        new = torch.tanh(state @ Wt + x_t)
        return new, new

    s, want = torch.zeros(W.shape[0]), []
    for x_t in torch.as_tensor(xs):
        s, y = step(s, x_t)
        want.append(y)
    want = torch.stack(want).numpy()
    _, want_j = jax.lax.scan(
        lambda st, xx: (jnp.tanh(st @ jnp.asarray(W.T) + xx),) * 2,
        jnp.zeros(W.shape[0]), jnp.asarray(xs))
    n = xs.shape[0] // world
    for ref in (want, np.asarray(want_j)):
        assert scan.shape == ref.shape
        np.testing.assert_allclose(scan[:n], ref[:n], atol=1e-5)
        assert np.median(np.abs(scan - ref).max(axis=1)) < 1e-3
    np.testing.assert_allclose(
        overlap_save_scan(step, torch.zeros(W.shape[0]), torch.as_tensor(xs),
                          warmup).numpy(), want, atol=1e-6)
    # the JAX package's own sharded scan, the same decomposition
    mesh = Mesh(np.array(jax.devices()[:world]), ("trials",))
    got_j = jax.jit(jax.shard_map(
        lambda xx: j_scan_sharded(
            lambda st, v: (jnp.tanh(st @ jnp.asarray(W.T) + v),) * 2,
            jnp.zeros(W.shape[0]), xx, warmup, "trials"),
        mesh=mesh, in_specs=(P("trials"),), out_specs=P("trials"),
        check_vma=False))(jnp.asarray(xs))
    np.testing.assert_allclose(scan, np.asarray(got_j), atol=1e-5)
    fir_j = jax.jit(jax.shard_map(
        lambda t, xx: j_sharded_fir(t, xx, "trials"), mesh=mesh,
        in_specs=(P(), P(None, "trials")), out_specs=P(None, "trials"),
        check_vma=False))(jnp.asarray(taps), jnp.asarray(x))
    np.testing.assert_allclose(fir, np.asarray(fir_j), rtol=1e-4, atol=1e-4)


def test_scaling_cli_at_one_gloo_rank(tmp_path):
    out = tmp_path / "scaling.json"
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0",
               PYTHONPATH=ROOT)
    run = subprocess.run(
        [sys.executable, "-m", "esn_ofdm_mimo_tpu_torch.experiments.scaling",
         "--preset", "siso_nbf", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    import json
    res = json.loads(out.read_text())
    assert list(res) == ["1"]
    assert res["1"]["blocks_per_s"] > 0 and res["1"]["efficiency"] == 1.0
    assert "[scaling] 1 rank: " in run.stdout
