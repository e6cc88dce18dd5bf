"""LDPC codes (QC, Gallager, pyldpc): construction (host, cached), encoder,
and the BP decoder — for QC codes the flooding or row-layered schedule,
CUDA kernels for CUDA tensors and plain PyTorch for CPU tensors; for the
other families flooding BP on the code's gather maps in plain PyTorch."""

from .code import (LdpcCode, QcInfo, make_code, make_pyldpc_ldpc,  # noqa: F401
                   make_qc_ldpc, make_regular_ldpc)
from .encode import ldpc_encode  # noqa: F401
from .decode import (ldpc_decode_bp, ldpc_decode_bp_counts,  # noqa: F401
                     ldpc_decode_bp_plain, llr_from_yobs)
