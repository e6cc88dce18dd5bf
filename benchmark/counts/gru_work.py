"""The least work of K7's launches (the program's csrc/gru_train.cu, the
zoo's per-block GRUs), frozen when the cell was defined, from the launch
shapes alone, for bounds.bound_s.

Bytes: each input read once and each output written once, fp32: a
training launch reads the B sequences (T, n_in), their targets (T, n_out)
and the weights, and writes the outputs, the losses and one gradient a
weight; a prediction launch reads the sequences and the weights and
writes the outputs. The kernel's own workspace (each step's gates, read
back by the backward pass) is its design's, not the function's, and is
not counted.

Operations, a step and sequence, fp32 (a multiply-add 2): forward, the
input and recurrent gate products 2 (n_in + nh) 3 nh, 3 nh bias and
gate-sum adds, GATE_OPS a unit for the gates' own arithmetic (two
sigmoids' negate, add and divide, the n gate's product and adds, the
update's four), the head 2 nh n_out + n_out; in training also the loss
(3 a output) and the backward pass: the output gradient back through the
head 2 nh n_out, BACK_OPS a unit for the gates' gradients, the recurrent
product 2 nh 3 nh + nh, and the weight gradients 2 (nh + n_in) 3 nh +
3 nh + 2 nh n_out + n_out. Transcendentals: 3 a unit and step (two exp,
one tanh)."""
from __future__ import annotations

HIDDEN, N_IN, N_OUT = 32, 4, 4
GATE_OPS = 17
BACK_OPS = 20


def _weights(nh: int = HIDDEN, n_in: int = N_IN, n_out: int = N_OUT) -> int:
    return n_in * 3 * nh + nh * 3 * nh + 3 * nh + nh * n_out + n_out


def _forward_ops(nh: int = HIDDEN, n_in: int = N_IN,
                 n_out: int = N_OUT) -> float:
    return (2.0 * (n_in + nh) * 3 * nh + 3 * nh + GATE_OPS * nh
            + 2.0 * nh * n_out + n_out)


def _backward_ops(nh: int = HIDDEN, n_in: int = N_IN,
                  n_out: int = N_OUT) -> float:
    return (3.0 * n_out + 2.0 * nh * n_out + BACK_OPS * nh
            + 2.0 * nh * 3 * nh + nh
            + 2.0 * (nh + n_in) * 3 * nh + 3 * nh + 2.0 * nh * n_out + n_out)


def train_work(blocks: int, T: int) -> tuple:
    """(bytes, operations, transcendentals) of one training launch."""
    w = _weights()
    n_bytes = 4.0 * (blocks * T * (N_IN + N_OUT) + blocks * w
                     + blocks * T * N_OUT + blocks + blocks * w)
    steps = float(blocks) * T
    return (n_bytes, steps * (_forward_ops() + _backward_ops()),
            steps * 3 * HIDDEN)


def predict_work(blocks: int, sequences: int, T: int) -> tuple:
    """(bytes, operations, transcendentals) of one prediction launch of
    `sequences` sequences a block."""
    rows = float(blocks) * sequences
    n_bytes = 4.0 * (rows * T * (N_IN + N_OUT) + blocks * _weights())
    return n_bytes, rows * T * _forward_ops(), rows * T * 3 * HIDDEN
