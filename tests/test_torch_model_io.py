"""The port's utils/model_io.py: nested dicts, lists, tuples and
NamedTuples of tensors round-trip through one .npz, written atomically;
a structure that differs from the saved one raises (the pattern of
tests/test_utils_io.py:12-33)."""
import os

import numpy as np
import pytest
import torch

from esn_ofdm_mimo_tpu_torch.models.esn import EsnScale, init_reservoir
from esn_ofdm_mimo_tpu_torch.utils import rng
from esn_ofdm_mimo_tpu_torch.utils.model_io import load_pytree, save_pytree

torch.set_num_threads(1)


def _state():
    res = init_reservoir(rng.prng_key(0), 4, 2, 30)
    return {"res": res, "scale": EsnScale(0.5, 0.0, 1e-2),
            "calib": (torch.arange(4.0), torch.zeros(4)),
            "keys": [rng.prng_key(3), rng.prng_key(4)],
            "count": torch.tensor(7, dtype=torch.int64), "steps": 12,
            "hist": torch.arange(6, dtype=torch.int32).reshape(2, 3)}


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


def test_round_trip(tmp_path):
    state = _state()
    p = str(tmp_path / "sub" / "ckpt.npz")
    save_pytree(p, state)
    assert sorted(os.listdir(tmp_path / "sub")) == ["ckpt.npz"]  # no .tmp
    like = {**state, "res": state["res"]._replace(
        Wt=torch.zeros(30, 30), noise=0.0), "steps": 0}
    out = load_pytree(p, like)
    assert type(out["res"]).__name__ == "EsnReservoir"
    assert isinstance(out["scale"], EsnScale)
    assert isinstance(out["calib"], tuple) and isinstance(out["keys"], list)
    assert out["steps"] == 12 and isinstance(out["steps"], int)
    assert out["res"].noise == state["res"].noise
    for a, b in zip(_leaves(state), _leaves(out)):
        if isinstance(a, torch.Tensor):
            assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
            assert torch.equal(a, b)
        else:
            assert a == b
    # saving again replaces the file in place
    save_pytree(p, {**state, "steps": 13})
    assert load_pytree(p, like)["steps"] == 13


@pytest.mark.parametrize("like", [
    {"b": (torch.zeros(3), torch.zeros(2))},
    {"a": (torch.zeros(3),)},
    {"a": [torch.zeros(3)]},
    {"a": EsnScale(0.0, 0.0, 0.0)},
], ids=["other-key", "tuple", "list", "namedtuple"])
def test_structure_mismatch_raises(tmp_path, like):
    p = str(tmp_path / "c.npz")
    save_pytree(p, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(p, like)
    np.testing.assert_array_equal(
        load_pytree(p, {"a": torch.ones(3)})["a"].numpy(), np.zeros(3))
