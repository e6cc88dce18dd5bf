"""K1, the flooding BP kernel (csrc/bp_decode.cu), against its bound
(decode cells): the frozen k1_work of each launch at the iterations its
codewords ran (the call's returned iteration sums, shared evenly by the
call's launches), over K1's device time in the trace."""
from benchmark.counts import bounds
from benchmark.readers import roofline_pct


def is_k1(name: str) -> bool:
    return "bp_flooding_kernel" in name


def work(s: dict, answer: dict, per_call: int) -> float:
    its = sum(v for k, v in answer.items()
              if k.startswith(("iter_sum.", "ldpc_iter_sum.")))
    return bounds.bound_s(*bounds.k1_work(s["codewords"], s["n"], s["k"],
                                          s["dv"], its / per_call,
                                          s["algo"]))


def read(run):
    return roofline_pct(run, "decode", "bp_decode", is_k1, work)
