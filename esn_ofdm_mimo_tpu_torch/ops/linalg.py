"""Dense linear algebra the port shares between modules.

`ns_solver` is the JAX package's Newton-Schulz SPD solver
(esn_ofdm_mimo_tpu/ops/linalg_mxu.py:ns_prepare). The port solves with it
where the result must equal the JAX package's on an ill-conditioned
system: the iteration's implicit regularisation is then the result (the
ESN readout, models/esn.py, and the ELM readout, models/elm.py).
"""
from __future__ import annotations

import torch


def ns_solver(A: torch.Tensor, iters: int = 40, refine: int = 2):
    """The JAX package's SPD solver (ops/linalg_mxu.py:ns_prepare /
    pd_solve_ns, here at 40 iterations): a Newton-Schulz inverse X <- X
    (2I - A X) of the Jacobi-prescaled batched symmetric A (..., F, F)
    from X_0 = A^T / (||A||_1 ||A||_inf), in fp32. Returns solve(b),
    which polishes each solution with `refine` steps against A. The
    iteration only resolves eigenvalues above ~2^-iters of the largest, so
    on a numerically singular A it returns a regularised inverse where a
    factorisation fails."""
    F = A.shape[-1]
    s = 1.0 / torch.sqrt(torch.clamp_min(
        torch.diagonal(A, dim1=-2, dim2=-1), 1e-30))
    As = A * s[..., :, None] * s[..., None, :]
    norm1 = As.abs().sum(-2).amax(-1)
    norminf = As.abs().sum(-1).amax(-1)
    X = As.transpose(-1, -2) / (norm1 * norminf)[..., None, None]
    I2 = 2.0 * torch.eye(F, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        X = X @ (I2 - As @ X)

    def solve(b: torch.Tensor) -> torch.Tensor:
        bs = b * s[..., :, None]
        x = X @ bs
        for _ in range(refine):
            x = x + X @ (bs - As @ x)
        return x * s[..., :, None]
    return solve
