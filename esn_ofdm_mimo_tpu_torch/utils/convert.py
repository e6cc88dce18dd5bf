"""Carry parameters across from the JAX package as numpy arrays.

The port imports nothing of the JAX package, so weights cross as plain numpy
data: a dict of the `EsnReservoir` / `EsnScale` fields, a readout array, and
the `LdpcCode` / `QcInfo` fields. These helpers turn them into the port's
types on a given device, so both packages can compute on identical
parameters (the parity tests do exactly that).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ldpc.code import LdpcCode, QcInfo
from ..models.esn import EsnReservoir, EsnScale


def tensor(a, device=None, dtype=torch.float32) -> torch.Tensor:
    """numpy (or array-like) -> contiguous tensor of `dtype` on `device`."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def reservoir(d: dict, device=None) -> EsnReservoir:
    """{"Wt", "W_in_t", "W_fb_t", "noise"} -> EsnReservoir (float32)."""
    return EsnReservoir(Wt=tensor(d["Wt"], device),
                        W_in_t=tensor(d["W_in_t"], device),
                        W_fb_t=tensor(d["W_fb_t"], device),
                        noise=float(np.asarray(d["noise"])))


def scale(d: dict) -> EsnScale:
    """{"input_scaling", "input_shift", "teacher_scaling"} (scalars) ->
    EsnScale of Python floats."""
    return EsnScale(*(float(np.asarray(d[k])) for k in EsnScale._fields))


def readout(Wt_out, device=None) -> torch.Tensor:
    """(G, F, n_out) readout stack -> float32 tensor."""
    return tensor(Wt_out, device)


def ldpc_code(d: dict) -> LdpcCode:
    """LdpcCode fields (with "qc" a dict of QcInfo fields, or None) ->
    the port's LdpcCode. Arrays stay numpy, as the port's codes keep them."""
    qc = d.get("qc")
    if qc is not None:
        qc = QcInfo(Z=int(qc["Z"]),
                    **{k: np.asarray(qc[k]) for k in QcInfo._fields[1:]})
    ints = {k: int(d[k]) for k in ("n", "k", "m", "dv", "dc")}
    arrays = {k: np.asarray(d[k]) for k in ("H", "P", "ck_cols", "var_edge")}
    return LdpcCode(**ints, **arrays, qc=qc)
