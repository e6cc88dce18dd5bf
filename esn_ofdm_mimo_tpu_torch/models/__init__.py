"""ESN engine (plain PyTorch), its CUDA predict kernel, and the MIMO
detection harness."""

from .esn import (EsnReservoir, EsnScale, init_reservoir,  # noqa: F401
                  esn_states, esn_fit, esn_predict)
from .esn_cuda import esn_predict_cuda  # noqa: F401
from .esn_mimo import (build_esn_io, build_esn_input,  # noqa: F401
                       train_mimo_esn, esn_detect_symbols)
