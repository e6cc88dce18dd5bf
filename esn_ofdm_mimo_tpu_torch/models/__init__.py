"""ESN engine (plain PyTorch), its CUDA predict and state-harvest kernels,
the MIMO detection harness, and the learners of system model 1 (models.elm,
models.zoo, models.classifiers; plain PyTorch). The state-harvest wrapper
is `models.esn_states_cuda.esn_states_cuda` (the module keeps its launch
count)."""

from .esn import (EsnReservoir, EsnScale, init_reservoir,  # noqa: F401
                  esn_fit, esn_states, esn_predict)
from .esn_cuda import esn_predict_cuda  # noqa: F401
from .esn_mimo import (build_esn_io, build_esn_input,  # noqa: F401
                       train_mimo_esn, esn_detect_symbols,
                       train_mimo_esn_per_block,
                       esn_detect_symbols_per_block)
