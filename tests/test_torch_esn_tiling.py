"""The predict kernels' row tiling (esn_ofdm_mimo_tpu_torch/models/esn_cuda.py:
predict_tiling), checked on the CPU: the plan is pure Python, the kernels it
feeds run on the card only.

  * the flagship and the mimo_4x8_nbf detect shapes on 132 SMs: one wave,
    shared memory within a block's limit, the busiest SM within 1.15x of the
    mean rows an SM;
  * a sweep over batch sizes, reservoir widths and SM counts: the blocks
    cover every row exactly once, the tile height is one the launcher
    builds and holds the block's rows, and the same bounds hold whenever the
    batch is at least 8 rows an SM (in `waves` equal rounds where one
    resident wave cannot hold the batch);
  * the grouped kernel's slot count follows the rows a block owns;
  * the kernels' weight layout.
"""
import numpy as np
import pytest
import torch

from esn_ofdm_mimo_tpu_torch.models import esn_cuda
from esn_ofdm_mimo_tpu_torch.models.esn import EsnReservoir

torch.set_num_threads(1)

FLAGSHIP = (9472, 300, 16, 8)      # rows, n_res, n_in, n_out
NBF = (2304, 600, 16, 8)
SMEM_SM = 233_472                  # shared memory of one SM
BUILT = {"narrow": (20, 72), "wide": (20,)}   # launch_any's heights


def _busiest(plan) -> int:
    """Rows the busiest SM holds: its blocks of every wave, all full."""
    return plan.waves * plan.blocks_per_sm * plan.rows_per_block


def _check_plan(plan, B, n_res, n_in, n_out, n_sm, slots=0):
    heights = BUILT["narrow" if n_res <= 320 else "wide"]
    assert plan.height in heights
    assert 1 <= plan.rows_per_block <= plan.height
    # blocks b owns rows [b * rows, min(B, (b + 1) * rows)): every row once,
    # no empty block
    assert plan.blocks == -(-B // plan.rows_per_block)
    assert (plan.blocks - 1) * plan.rows_per_block < B
    assert plan.smem_bytes == esn_cuda.predict_smem_bytes(
        n_res, n_in, n_out, plan.height, slots)
    assert plan.smem_bytes <= esn_cuda.SMEM_BLOCK_MAX == 232_448
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SMEM_SM
    assert plan.blocks <= n_sm * plan.blocks_per_sm * plan.waves
    if plan.blocks_per_sm > 1:        # two blocks an SM: 128-thread tiles only
        assert esn_cuda.block_threads(n_res, plan.height) == 128
    if B >= 8 * n_sm:
        assert _busiest(plan) <= 1.15 * B / n_sm


@pytest.mark.parametrize("shape,rows,height", [
    (FLAGSHIP, 72, 72),      # 132 blocks of 72 rows, the last of 40
    (NBF, 18, 20),           # 128 blocks of 18 rows
])
def test_full_width_shapes_fill_the_card_in_one_wave(shape, rows, height):
    plan = esn_cuda.predict_tiling(*shape, 132)
    _check_plan(plan, *shape, 132)
    assert plan.waves == 1 and plan.blocks <= 132 * plan.blocks_per_sm
    assert (plan.rows_per_block, plan.height) == (rows, height)
    assert _busiest(plan) <= 1.15 * shape[0] / 132


@pytest.mark.parametrize("n_sm", [108, 132])
@pytest.mark.parametrize("n_res", [64, 300, 600, 640])
def test_sweep_over_batch_sizes(n_res, n_sm):
    rng = np.random.default_rng(n_res * 1000 + n_sm)
    batches = set(range(1, 300)) | {8 * n_sm - 1, 8 * n_sm, 8 * n_sm + 1,
                                    20_000} \
        | set(int(b) for b in rng.integers(1, 20_001, size=1500))
    one_wave = 0
    for B in sorted(batches):
        plan = esn_cuda.predict_tiling(B, n_res, 16, 8, n_sm)
        _check_plan(plan, B, n_res, 16, 8, n_sm)
        one_wave += plan.waves == 1
        # one wave whenever a resident wave of the tallest tile holds B
        tallest = max(esn_cuda.tile_heights(n_res))
        if B <= n_sm * tallest:
            assert plan.waves == 1, (B, plan)
    assert one_wave > 0


def test_sweep_with_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=300, deadline=None, database=None)
    @hypothesis.given(B=st.integers(1, 20_000),
                      n_res=st.sampled_from([64, 300, 600, 640]),
                      n_in=st.sampled_from([2, 4, 16]),
                      n_out=st.sampled_from([2, 4, 8]),
                      n_sm=st.sampled_from([108, 132]))
    def check(B, n_res, n_in, n_out, n_sm):
        _check_plan(esn_cuda.predict_tiling(B, n_res, n_in, n_out, n_sm),
                    B, n_res, n_in, n_out, n_sm)

    check()


def test_tile_heights_are_those_the_launcher_builds():
    assert esn_cuda.tile_heights(300) == BUILT["narrow"]
    assert esn_cuda.tile_heights(320) == BUILT["narrow"]
    assert esn_cuda.tile_heights(321) == BUILT["wide"]
    assert esn_cuda.tile_heights(640) == BUILT["wide"]
    assert esn_cuda.tile_heights(300, "ablate") == (72,)
    plan = esn_cuda.predict_tiling(9472, 300, 16, 8, 132, heights=(72,))
    assert (plan.height, plan.rows_per_block, plan.blocks) == (72, 72, 132)
    # a batch the 72-row tile holds in two rounds of 132 blocks
    plan = esn_cuda.predict_tiling(15_000, 300, 16, 8, 132, heights=(72,))
    assert plan.waves == 2 and plan.blocks <= 264
    assert _busiest(plan) <= 1.15 * 15_000 / 132


def test_no_tile_fits_raises():
    with pytest.raises(ValueError, match="no predict tile fits"):
        esn_cuda.predict_tiling(1000, 640, 16, 8, 132, heights=(200,))


@pytest.mark.parametrize("shape,G,slots", [
    (FLAGSHIP, 128, 2),      # 72 rows a block over runs of 74
    (NBF, 128, 3),           # 18 rows a block over runs of 18
])
def test_grouped_slots_follow_the_tile(shape, G, slots):
    B, n_res, n_in, n_out = shape
    plan = esn_cuda.grouped_plan(B, G, n_res, n_in, n_out, 132)
    assert plan is not None and plan.waves == 1
    Dg = B // G
    assert esn_cuda.grouped_slots(G, Dg, plan.rows_per_block) == slots \
        == min(G, plan.rows_per_block // Dg + 2)
    assert esn_cuda.grouped_viable(G, Dg, plan.rows_per_block)
    _check_plan(plan, B, n_res, n_in, n_out, 132, slots)
    # the staged slots are part of the block's shared memory
    assert plan.smem_bytes == esn_cuda.predict_smem_bytes(
        n_res, n_in, n_out, plan.height) \
        + slots * ((n_res + n_in) * n_out + 8) * 4


@pytest.mark.parametrize("B,G,why", [
    (9472, 9472, "one readout a row"),
    (2304, 1152, "runs of 2 rows: 18 // 2 + 2 = 11 slots a block"),
])
def test_grouped_plan_is_none_where_the_kernel_does_not_apply(B, G, why):
    assert esn_cuda.grouped_plan(B, G, 600, 16, 8, 132) is None, why


@pytest.mark.parametrize("rows,Dg,G,slots", [
    (64, 74, 128, 2), (64, 18, 128, 5), (18, 18, 128, 3), (20, 18, 128, 3),
    (72, 74, 128, 2), (72, 74, 1, 1), (1, 5, 7, 2),
])
def test_grouped_slots_formula(rows, Dg, G, slots):
    assert esn_cuda.grouped_slots(G, Dg, rows) == slots
    assert esn_cuda.grouped_viable(G, Dg, rows) is (Dg > 1 and slots <= 4)


def test_choose_readout_on_cpu_runs_either_name():
    cpu = torch.device("cpu")
    assert esn_cuda.choose_readout(9472, 128, 300, 16, 8, cpu) == "grouped"
    assert esn_cuda.choose_readout(9472, 9472, 300, 16, 8, cpu) == "per_row"


@pytest.mark.parametrize("n_res,n_in,n_out", [(50, 4, 2), (300, 16, 8),
                                              (600, 16, 8), (64, 8, 8)])
def test_predict_weights_layout(n_res, n_in, n_out):
    g = np.random.default_rng(n_res)
    res = EsnReservoir(
        Wt=torch.as_tensor(g.standard_normal((n_res, n_res), np.float32)),
        W_in_t=torch.as_tensor(g.standard_normal((n_in, n_res), np.float32)),
        W_fb_t=torch.as_tensor(g.standard_normal((n_out, n_res), np.float32)),
        noise=0.0)
    Wc = esn_cuda.predict_weights(res, n_in, n_out)
    n8 = -(-n_res // 8) * 8
    assert Wc.shape == (n8 + -(-(n_in + n_out) // 8) * 8, -(-n_res // 64) * 64)
    torch.testing.assert_close(Wc[:n_res, :n_res], res.Wt)
    torch.testing.assert_close(Wc[n8:n8 + n_in, :n_res], res.W_in_t)
    torch.testing.assert_close(Wc[n8 + n_in:n8 + n_in + n_out, :n_res],
                               res.W_fb_t)
    # nothing else: the padding rows and columns are zero
    assert float(Wc.abs().sum()) == pytest.approx(float(
        res.Wt.abs().sum() + res.W_in_t.abs().sum() + res.W_fb_t.abs().sum()),
        rel=1e-5)
    assert float(Wc[:, n_res:].abs().sum()) == 0.0
    # [s; u; o] @ Wc is the recurrence's pre-activation
    s, u, o = (torch.as_tensor(g.standard_normal(n, np.float32))
               for n in (n_res, n_in, n_out))
    x = torch.zeros(Wc.shape[0])
    x[:n_res], x[n8:n8 + n_in], x[n8 + n_in:n8 + n_in + n_out] = s, u, o
    want = s @ res.Wt + u @ res.W_in_t + o @ res.W_fb_t
    torch.testing.assert_close((x @ Wc)[:n_res], want, atol=1e-4, rtol=1e-4)
