"""What the entries share: the program's launch counters, which only a
call that captures its graphs again moves."""
from __future__ import annotations


def python_launches() -> tuple:
    """K1, K2 and K3 launched from Python so far: a graph's warm-up and
    capture launch from Python, its replays do not."""
    from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda
    from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_states_cuda
    return (decode_cuda.launches, esn_cuda.launches,
            esn_states_cuda.launches)


def capture_stats(key_args: tuple) -> tuple:
    """(captures' host ms, bytes the pool grew by) of the cached graph set
    of graph_key(*key_args)."""
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    g = graphs.cached_graphs(graphs.graph_key(*key_args), lambda: None)
    if g is None:
        return 0.0, 0
    if hasattr(g, "capture_stats"):
        return g.capture_stats()
    return g.capture_ms, g.pool_bytes


def esn_shapes(sim, rows: int, readouts: int, n_res: int) -> dict:
    """One ESN predict launch's shape (K2)."""
    isi, cp = sim.ofdm.isi_duration, sim.ofdm.cp_len
    delay = sim.esn.shared_delay(isi)
    return {"rows": rows, "T": sim.ofdm.n_subcarriers + cp + delay,
            "n_forget": delay + cp, "n_res": n_res,
            "n_in": 2 * sim.channel.n_rx, "n_out": 2 * sim.channel.n_tx,
            "readouts": readouts}


def free(dev):
    """Release the program's captured graphs and their memory, before the
    reference runs."""
    import torch
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    graphs.release_graphs()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
