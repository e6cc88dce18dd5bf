"""The least time the card could take for a kernel's work, frozen when
the benchmark was defined: copies of the program's chip_smoke.py
arithmetic (`_bound`, `predict_work`, `k1_work`), taken from the launch
shapes alone.

A bound is the largest of bytes over the HBM rate, fp32 operations over
the fp32 peak and transcendentals over the special-function unit's rate.
The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, 700 W): 3.35
TB/s of HBM and 67 TFLOP/s of fp32 outside the tensor cores. The
special-function unit gives 16 results a clock on each SM against 128 fp32
lanes of 2 flops (the CUDA C++ Programming Guide's arithmetic-throughput
table for compute capability 9.0): a sixteenth of the fp32 peak.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_PER_S = FP32_FLOP_PER_S / 16


def bound_s(n_bytes: float, ops: float, transc: float = 0.0) -> float:
    """The least seconds for the work: the largest of its three terms."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S,
               transc / SFU_PER_S)


def predict_work(rows: int, T: int, n_forget: int, n_res: int, n_in: int,
                 n_out: int, readouts: int) -> tuple:
    """(bytes, operations) of one ESN predict launch (K2): the inputs
    (rows, T, n_in), the readouts (readouts, n_res + n_in, n_out) and the
    weights [W | W_in | W_fb] in, the outputs (rows, T - n_forget, n_out)
    out; 2 flops a multiply-add of [W | W_in | W_fb] and of the readout,
    and a tanh, a row and step."""
    n_bytes = 4 * (rows * T * n_in + readouts * (n_res + n_in) * n_out
                   + rows * (T - n_forget) * n_out
                   + n_res * (n_res + n_in + n_out))
    ops = float(rows) * T * (2 * n_res * (n_res + n_in + n_out)
                             + 2 * (n_res + n_in) * n_out + n_res)
    return n_bytes, ops


def k1_work(codewords: int, n: int, k: int, dv: int, iterations: int,
            algo: str) -> tuple:
    """(bytes, operations, transcendentals) of BP decoding (K1): the LLRs
    (codewords, n) fp32 and the true info bits (codewords, k) int8 in, the
    counts and stats out (9 bytes a codeword); 13 fp32 operations an edge
    and executed iteration (q = Lt - r, two clips, |q|, the two minima,
    sign, select, offset, max, sign product, posterior add, parity), and 2
    transcendentals an edge and iteration under sum-product (one tanh-like,
    one log-like), none under the min-sum rules. `iterations` is the sum of
    the codewords' own iterations."""
    edge_its = float(dv) * n * iterations
    return (codewords * (4 * n + k + 9), 13.0 * edge_its,
            2.0 * edge_its if algo == "sumprod" else 0.0)
