"""QC-LDPC codes: construction (host, cached), encoder, and the BP decoder
(flooding or row-layered schedule) — CUDA kernels for CUDA tensors, plain
PyTorch for CPU tensors."""

from .code import LdpcCode, QcInfo, make_qc_ldpc, make_code  # noqa: F401
from .encode import ldpc_encode  # noqa: F401
from .decode import (ldpc_decode_bp, ldpc_decode_bp_counts,  # noqa: F401
                     ldpc_decode_bp_plain, llr_from_yobs)
