"""esn_ofdm_mimo_tpu_torch — the PyTorch/CUDA port of esn_ofdm_mimo_tpu.

The JAX package `esn_ofdm_mimo_tpu` is the reference; this package mirrors
its module layout and names (config, experiments.presets, ops, models, ldpc,
pipelines, parallel, utils) so each module's counterpart is found by path.
It imports torch and numpy only, never jax and nothing of the JAX package.

Idiom: plain functions on tensors; a tensor's device decides where the work
runs; entry points take `device=` (default "cuda", and they raise when CUDA
is absent unless the caller asks for "cpu"). The two hand-written CUDA
kernels of the main path sit behind wrappers that launch them for CUDA
tensors and run their plain PyTorch versions for CPU tensors:

  ldpc/decode_cuda.py   + csrc/bp_decode.cu    (BP decoder; TPU: _bp_kernel)
  models/esn_cuda.py    + csrc/esn_predict.cu  (ESN predict; TPU: _predict_kernel)

The data path is fp32 (no TF32 anywhere): both TF32 switches are turned off
here, at import.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
