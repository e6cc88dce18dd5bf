"""The state-harvest kernel's cluster plan and weight layout
(esn_ofdm_mimo_tpu_torch/models/esn_states_cuda.py), checked on the CPU: the
plan and the slices are Python, the kernel they feed runs on the card only.

  * states_plan over batch sizes 1-1,024, reservoir widths 1-640, n_in +
    n_out <= 24 and two SM counts (hypothesis, as
    tests/test_torch_esn_tiling.py does): a plan exists, every row is owned
    by exactly one cluster, every neuron column by one CTA, the cluster size
    is one the launcher takes, all clusters fit the card at once, and shared
    memory, threads and the drive prefetch fit a block;
  * the full-width mimo_4x8_nbf and flagship fit plans pinned, on the H100's
    active-cluster counts and on a card that holds n_sm // C clusters;
  * the weight slices the launcher cuts, put back together, are
    `stacked_weights`; and the cluster's step computed slice by slice from
    them (each CTA's product over the whole K, the slices' states
    concatenated) is the plain recurrence, esn_states, at noise 0.
"""
import numpy as np
import pytest
import torch

from esn_ofdm_mimo_tpu_torch.models import esn_states_cuda as k3
from esn_ofdm_mimo_tpu_torch.models.esn import (EsnReservoir, EsnScale,
                                                esn_states, scale_inputs)
from esn_ofdm_mimo_tpu_torch.models.esn_cuda import stacked_weights

torch.set_num_threads(1)


def _check_plan(p, B, n_res, n_in, n_out, n_sm):
    C = p.cluster
    assert C in (2, 4, 8, 16)
    # rows: cluster c owns [c * rows, min(B, (c + 1) * rows)), none empty
    assert p.clusters == -(-B // p.rows_per_cluster)
    assert (p.clusters - 1) * p.rows_per_cluster < B
    assert p.clusters * C <= n_sm
    assert p.row_tile in k3.ROW_TILES
    # columns: rank r owns [r * cols, min(n_res, (r + 1) * cols)), so
    # neuron j belongs to rank j // cols alone (ranks past n_res own none)
    assert p.cols_per_cta == -(-n_res // C)
    assert (n_res - 1) // p.cols_per_cta < C
    cp = k3.cols_pad(n_res, C)
    assert cp >= p.cols_per_cta and cp % 4 == 0 and (cp // 4) % 2 == 1
    assert cp // 4 <= 22                       # <= 11 warps, 8 columns each
    threads = k3.cta_threads(n_res, C)
    assert threads == 32 * -(-(cp // 4) // 2) <= 352
    assert (n_in + n_out) * p.row_tile <= 2 * threads   # the drive prefetch
    assert p.smem_bytes == k3.states_smem_bytes(n_res, n_in, n_out, C,
                                                p.row_tile)
    assert p.smem_bytes == 4 * (n_res + n_in + n_out) * (cp + 2 * p.row_tile)
    assert p.smem_bytes <= 232_448


# An H100 (132 SMs) holds, at one CTA an SM, 15 clusters of 8, 30 of 4 and 7
# of 16 (cudaOccupancyMaxActiveClusters, tools/bench_states_torch.py); a card
# that held n_sm // C clusters would get the plans of the last two cases.
H100 = {2: 0, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("shape,counts,want", [
    # mimo_4x8_nbf fit on the H100: 15 clusters of 8 CTAs, 9 rows each in a
    # tile of 8 and a tile of 1, 75 columns a CTA, a 187 KB slice and two
    # 20 KB X buffers
    ((128, 600, 16, 8), H100, (8, 15, 9, 75, 229_632, 8)),
    # flagship fit on the H100: 26 clusters of 4 CTAs, 5 rows each in one
    # tile of 8, a 98 KB slice
    ((128, 300, 16, 8), H100, (4, 26, 5, 75, 119_232, 8)),
    # on a card that held n_sm // C clusters: 16 clusters of 8 rows, and 32
    # of 4 rows in tiles of 4
    ((128, 600, 16, 8), None, (8, 16, 8, 75, 229_632, 8)),
    ((128, 300, 16, 8), None, (4, 32, 4, 75, 108_864, 4)),
])
def test_full_width_fit_plans(shape, counts, want):
    p = k3.states_plan(*shape, 132, counts)
    _check_plan(p, *shape, 132)
    assert tuple(p) == want


def test_plan_follows_the_cards_cluster_counts():
    # a card that holds 7 clusters of 16 and no cluster of 2: C = 8 as before
    p = k3.states_plan(128, 600, 16, 8, 132, {2: 0, 4: 33, 8: 16, 16: 7})
    assert (p.cluster, p.clusters) == (8, 16)
    # a card with no cluster of 8 left: the NBF fit goes to 16 in 2 tiles
    p = k3.states_plan(128, 600, 16, 8, 132, {8: 0, 16: 8})
    assert (p.cluster, p.clusters, p.rows_per_cluster) == (16, 8, 16)
    _check_plan(p, 128, 600, 16, 8, 132)
    with pytest.raises(ValueError, match="no state-harvest cluster plan"):
        k3.states_plan(128, 640, 16, 8, 132, {C: 0 for C in (2, 4, 8, 16)})


@pytest.mark.parametrize("n_sm", [108, 132])
@pytest.mark.parametrize("n_res", [1, 7, 64, 300, 600, 608, 640])
def test_plan_sweep(n_res, n_sm):
    for B in list(range(1, 140)) + [255, 256, 257, 500, 1000, 1023, 1024]:
        for n_in, n_out in ((16, 8), (2, 2), (1, 23)):
            _check_plan(k3.states_plan(B, n_res, n_in, n_out, n_sm), B,
                        n_res, n_in, n_out, n_sm)


def test_plan_sweep_with_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=300, deadline=None, database=None)
    @hypothesis.given(B=st.integers(1, 1024), n_res=st.integers(1, 640),
                      n_in=st.integers(1, 23), n_out=st.integers(1, 23),
                      n_sm=st.sampled_from([108, 132]))
    def check(B, n_res, n_in, n_out, n_sm):
        hypothesis.assume(n_in + n_out <= 24)
        _check_plan(k3.states_plan(B, n_res, n_in, n_out, n_sm), B, n_res,
                    n_in, n_out, n_sm)

    check()


def _reservoir(n_res, n_in, n_out, seed=0, rho=None):
    """Uniform weights; with `rho` the recurrent one at that spectral
    radius."""
    g = np.random.default_rng(seed)
    W = g.uniform(-0.5, 0.5, (n_res, n_res))
    if rho is not None:
        W *= rho / np.max(np.abs(np.linalg.eigvals(W)))
    f = lambda a: torch.as_tensor(a.astype(np.float32))       # noqa: E731
    return EsnReservoir(Wt=f(W.T), W_in_t=f(g.uniform(-1, 1, (n_in, n_res))),
                        W_fb_t=f(g.uniform(-1, 1, (n_out, n_res))),
                        noise=0.0)


@pytest.mark.parametrize("n_res,C", [(600, 8), (300, 4), (50, 16), (7, 2),
                                     (640, 16)])
def test_weight_slices_reassemble_stacked_weights(n_res, C):
    res = _reservoir(n_res, 16, 8, seed=n_res)
    K = n_res + 24
    wsl = k3.weight_slices(res, 16, 8, C)
    cols, cp = -(-n_res // C), k3.cols_pad(n_res, C)
    assert wsl.shape == (C, K, cp) and wsl.is_contiguous()
    assert float(wsl[:, :, cols:].abs().sum()) == 0.0      # padding columns
    back = wsl[:, :, :cols].permute(1, 0, 2).reshape(K, C * cols)[:, :n_res]
    torch.testing.assert_close(back, stacked_weights(res, 16, 8, K, n_res),
                               rtol=0, atol=0)
    assert float(wsl.reshape(-1).abs().sum()) == pytest.approx(
        float(back.abs().sum()), rel=1e-6)       # nothing beyond n_res


def test_cluster_step_by_slices_is_the_plain_recurrence():
    """The kernel's arithmetic at a small size: each CTA multiplies the full
    X = [s_{t-1}; z_t] by its slice, the C slices of s_t are concatenated
    (the pushes)."""
    B, T, n_res, n_in, n_out, C = 5, 12, 37, 4, 2, 4
    res = _reservoir(n_res, n_in, n_out, seed=3, rho=0.9)
    scale = EsnScale(input_scaling=0.5, input_shift=0.1, teacher_scaling=1.0)
    g = np.random.default_rng(4)
    x = torch.as_tensor(g.standard_normal((B, T, n_in)).astype(np.float32))
    d = torch.as_tensor(g.standard_normal((B, T, n_out)).astype(np.float32))
    want = esn_states(res, scale, x, d)
    wsl = k3.weight_slices(res, n_in, n_out, C)
    cols = -(-n_res // C)
    u = scale_inputs(scale, x)
    s = torch.zeros(B, n_res)
    got = torch.zeros(B, T, n_res)
    for t in range(1, T):
        X = torch.cat([s, u[:, t], d[:, t - 1]], dim=1)       # (B, K)
        s = torch.cat([torch.tanh(X @ wsl[r])[:, :cols] for r in range(C)],
                      dim=1)[:, :n_res]
        got[:, t] = s
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rt,left,want", [(8, 1, 1), (8, 2, 2), (8, 3, 4),
                                          (8, 5, 8), (16, 9, 16), (4, 3, 4),
                                          (1, 1, 1)])
def test_tail_tile(rt, left, want):
    # the rows a cluster has left after its full tiles run in the smallest
    # built tile that holds them (csrc/esn_states.cu:tile_rows)
    assert k3.tail_tile(rt, left) == want


def test_plan_on_a_card_that_holds_15_clusters_of_8():
    # 128 NBF rows on 15 clusters of 8: 9 rows a cluster, a tile of 8 and a
    # tile of 1, not two tiles of 8 or a cluster of 16 in two tiles of 16
    p = k3.states_plan(128, 600, 16, 8, 132, {2: 0, 4: 0, 8: 15, 16: 7})
    assert tuple(p) == (8, 15, 9, 75, 229_632, 8)
    assert k3.tail_tile(p.row_tile, p.rows_per_cluster % p.row_tile) == 1
