"""LDPC codes (QC, Gallager, pyldpc): construction (host, cached), encoder,
and the BP decoder — for QC codes the flooding or row-layered schedule,
CUDA kernels for CUDA tensors and plain PyTorch for CPU tensors; for the
other families flooding BP on the code's gather maps in plain PyTorch; and
the 5G NR code of system model 1 (ldpc/nr.py: encoder, plain BP), whose
base graph is a structure-exact surrogate (`NR_SURROGATE_CAVEAT`)."""

from .code import (LdpcCode, QcInfo, make_code, make_pyldpc_ldpc,  # noqa: F401
                   make_qc_ldpc, make_regular_ldpc)
from .encode import ldpc_encode, ldpc_extract_message  # noqa: F401
from .decode import (ldpc_decode_bp, ldpc_decode_bp_counts,  # noqa: F401
                     ldpc_decode_bp_plain, llr_from_yobs)
from .nr import (make_nr_ldpc, nr_encode, nr_decode_bp,  # noqa: F401
                 nr_derate_llrs, nr_lifted_H, NR_SURROGATE_CAVEAT,
                 BG_TABLES_SOURCE, basegraph_fingerprint)
