"""QC LDPC codes: construction (host, cached), encoder and plain BP."""

from .code import LdpcCode, QcInfo, make_code  # noqa: F401
from .encode import ldpc_encode, ldpc_extract_message  # noqa: F401
from .decode import (ldpc_decode_bp_counts,  # noqa: F401
                     ldpc_decode_bp_plain, llr_from_yobs)
