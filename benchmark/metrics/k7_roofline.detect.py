"""K7, the zoo's GRU kernel (csrc/gru_train.cu), against its bound (the
zoo cell): the frozen gru_work of each launch (training: forward and
backward pass of every block's pilot; prediction: forward passes), over
K7's device time in the trace. Its traced names: gru_train_kernel and
gru_predict_kernel."""
from benchmark.counts import bounds, gru_work
from benchmark.readers import roofline_pct


def is_k7(name: str) -> bool:
    return "gru_train_kernel" in name or "gru_predict_kernel" in name


def work(s: dict, answer: dict, per_call: int) -> float:
    if s["mode"] == "train":
        return bounds.bound_s(*gru_work.train_work(s["blocks"], s["T"]))
    return bounds.bound_s(*gru_work.predict_work(s["blocks"], s["sequences"],
                                                 s["T"]))


def read(run):
    return roofline_pct(run, "detect", "gru_train", is_k7, work)
