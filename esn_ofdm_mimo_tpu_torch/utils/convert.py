"""Carry parameters across from the JAX package as numpy arrays.

The port imports nothing of the JAX package, so weights cross as plain numpy
data: a dict of the `EsnReservoir` / `EsnScale` fields, a readout array,
the `LdpcCode` / `QcInfo` and `NrCode` fields, and the zoo's classifier
and regressor parameter trees (also vmapped ones, one tree a block). These
helpers turn them into the port's types on a given device, so both
packages can compute on identical parameters (the parity tests do exactly
that).
"""
from __future__ import annotations

import numpy as np
import torch

from torch import nn

from ..ldpc.code import LdpcCode, QcInfo
from ..ldpc.nr import NrCode
from ..models import classifiers as clf
from ..models import zoo
from ..models.elm import ElmParams
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


def nr_code(d: dict) -> NrCode:
    """NrCode fields -> the port's NrCode (arrays stay numpy, H_rows a
    tuple of (i, j, shift) int triples)."""
    ints = {k: int(d[k]) for k in ("k", "E", "bg", "Z", "iLS", "kb", "K",
                                   "F", "m_b", "n_b")}
    return NrCode(**ints, M=np.asarray(d["M"]), sel=np.asarray(d["sel"]),
                  H_rows=tuple(tuple(int(v) for v in r) for r in d["H_rows"]))


def _dense(d: dict, device) -> zoo.Dense:
    return zoo.Dense(tensor(d["w"], device), tensor(d["b"], device))


def _mlp(layers, device) -> nn.ModuleList:
    return nn.ModuleList([_dense(lyr, device) for lyr in layers])


def classifier(name: str, tree, device=None):
    """One classifier's JAX parameters (numpy leaves; a NamedTuple as its
    `_asdict()`) -> the port's parameters for the matching apply:
      esn       {"W_in", "W_out", "b_out"} -> the training tree (W_in a
                buffer)
      deep_esn  {"W_in", "hidden": [{"w", "b"}, ...]} -> the training tree
      fnn       [{"w", "b"}, ...]           -> nn.ModuleList of Dense
      cnn       {"c1", "c2": {"w", "b"}, "mlp": [...]} -> zoo.Params
      rnn       {"wx", "wh", "b", "mlp": [...]} -> zoo.Params
      elm       {"W1", "b1", "W2"}          -> ElmParams"""
    def t(k):
        return tensor(tree[k], device)

    if name == "esn":
        return clf.esn_classifier_params(
            clf.EsnClassifierParams(t("W_in"), t("W_out"), t("b_out")))
    if name == "deep_esn":
        return clf.deep_esn_params(
            clf.DeepEsnParams(t("W_in"), _mlp(tree["hidden"], device)))
    if name == "fnn":
        return _mlp(tree, device)
    if name == "cnn":
        return zoo.Params({"c1": _dense(tree["c1"], device),
                           "c2": _dense(tree["c2"], device),
                           "mlp": _mlp(tree["mlp"], device)})
    if name == "rnn":
        return zoo.Params({"wx": t("wx"), "wh": t("wh"), "b": t("b"),
                           "mlp": _mlp(tree["mlp"], device)})
    if name == "elm":
        return ElmParams(t("W1"), t("b1"), t("W2"))
    raise ValueError(f"unknown classifier {name!r}")


def regressor(name: str, tree, device=None):
    """One regressor's JAX parameters (numpy leaves) -> the port's tree for
    the matching apply of models/zoo.py:
      cnn  {"convs": [{"w", "b"}, ...], "head": {"w", "b"}} -> zoo.Params
      rnn  {"wi", "wh", "bi", "head": {"w", "b"}}          -> zoo.Params
      fnn  [{"w", "b"}, ...]                                -> nn.ModuleList"""
    if name == "cnn":
        return zoo.Params({"convs": _mlp(tree["convs"], device),
                           "head": _dense(tree["head"], device)})
    if name == "rnn":
        return zoo.Params({k: tensor(tree[k], device)
                           for k in ("wi", "wh", "bi")}
                          | {"head": _dense(tree["head"], device)})
    if name == "fnn":
        return _mlp(tree, device)
    raise ValueError(f"unknown regressor {name!r}")


def _block(tree, b: int):
    """Block b of a vmapped tree: every leaf indexed at b."""
    if isinstance(tree, dict):
        return {k: _block(v, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_block(v, b) for v in tree]
    return np.asarray(tree)[b]


def regressors_per_block(name: str, tree, device=None) -> list:
    """A vmapped regressor tree (every leaf with a leading block axis B, as
    `jax.vmap(init)` or `jax.vmap(train)` returns it) -> the port's B trees,
    the models `zoo.train_regressor_per_block` takes."""
    leaf = tree
    while isinstance(leaf, (dict, list, tuple)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return [regressor(name, _block(tree, b), device)
            for b in range(np.asarray(leaf).shape[0])]
