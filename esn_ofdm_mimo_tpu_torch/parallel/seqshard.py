"""Sequence-axis sharding: the FIR halo exchange and the overlap-save scan
(port of esn_ofdm_mimo_tpu/parallel/seqshard.py), in plain PyTorch over the
ranks of a `torch.distributed` process group.

A long waveform is cut along time into one contiguous shard a rank, in rank
order. Two of the reference's mechanics carry over to such a split:

  * `sharded_fir`: the causal FIR channel needs the isi - 1 samples before
    a shard; rank r receives them from rank r - 1 (point to point), rank 0
    takes zeros, and each rank then filters its shard alone;
  * `overlap_save_scan`: a stateful scan (the ESN recurrence) re-runs the
    last `warmup` inputs of the left neighbour from the initial state and
    drops their outputs: the reference's transient / nForgetPoints
    overlap-discard (pyESN.py:191, helper_mimo_esn_generic.py:43) as a
    parallel decomposition. The echo-state property (spectral radius < 1)
    bounds the error it leaves.

`group` None is one process, the whole sequence on rank 0. Tensors go
over the wire as they are: CUDA tensors under NCCL, CPU tensors under
gloo.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..ops.channel import apply_fir_channel


def _left_halo(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """The last `halo` entries of the left neighbour's x along dim 0 (time
    first); zeros on the group's first rank."""
    recv = torch.zeros(x[-halo:].shape, dtype=x.dtype, device=x.device)
    if group is None:
        return recv
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    send = x[-halo:].contiguous()
    as_real = torch.view_as_real if x.is_complex() else (lambda t: t)
    ops = []
    if rank + 1 < size:
        ops.append(dist.P2POp(dist.isend, as_real(send),
                              dist.get_global_rank(group, rank + 1), group))
    if rank > 0:
        ops.append(dist.P2POp(dist.irecv, as_real(recv),
                              dist.get_global_rank(group, rank - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def sharded_fir(taps: torch.Tensor, x: torch.Tensor, group=None
                ) -> torch.Tensor:
    """Causal FIR over a time-sharded signal: taps (..., n_rx, n_tx, isi)
    the same on every rank, x (..., n_tx, T_local) this rank's shard ->
    (..., n_rx, T_local), lfilter's result over the whole sequence."""
    isi = taps.shape[-1]
    if isi == 1 or group is None:
        return apply_fir_channel(taps, x)
    halo = isi - 1
    prev = _left_halo(x.movedim(-1, 0), halo, group).movedim(0, -1)
    y = apply_fir_channel(taps, torch.cat([prev, x], dim=-1))
    return y[..., halo:]


def overlap_save_scan(step_fn: Callable, init_state, xs: torch.Tensor,
                      warmup: int, group=None) -> torch.Tensor:
    """A stateful scan over a time-sharded input: step_fn(state, x_t) ->
    (state, y_t), xs (T_local, ...) this rank's shard, time first. Each rank
    prepends the last `warmup` inputs of its left neighbour (rank 0: zeros),
    scans from `init_state` and drops the warmup's outputs -> (T_local,
    ...) outputs."""
    ext = torch.cat([_left_halo(xs, warmup, group), xs], dim=0)
    state, ys = init_state, []
    for x_t in ext:
        state, y = step_fn(state, x_t)
        ys.append(y)
    return torch.stack(ys[warmup:])
