"""K2, the ESN predict kernel (csrc/esn_predict.cu), against its bound
(decode cells): the frozen predict_work at each launch's shape, over K2's
device time in the trace. Its traced name: predict_kernel<..., false, ...>
(the per-row readout; the grouped build has true there)."""
from benchmark.counts import bounds
from benchmark.readers import roofline_pct


def is_k2(name: str) -> bool:
    return ("predict_kernel<" in name
            and name.split("predict_kernel<")[1].split(",")[2].strip()
            == "false")


def work(s: dict, answer: dict, per_call: int) -> float:
    n_bytes, ops = bounds.predict_work(s["rows"], s["T"], s["n_forget"],
                                       s["n_res"], s["n_in"], s["n_out"],
                                       s["readouts"])
    return bounds.bound_s(n_bytes, ops)


def read(run):
    return roofline_pct(run, "decode", "esn_predict", is_k2, work)
