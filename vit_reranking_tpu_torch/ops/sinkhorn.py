"""Entropic Sinkhorn optimal transport, batched (PyTorch).

Port of vit_reranking_tpu/ops/sinkhorn.py (reference utilities/diml.py:42-75).
The reference runs a loop with a data-dependent early break
(``mean|r - r0| < thresh``); here the break is a *freeze*: once a problem's
mean residual drops below the threshold its scaling vectors stop updating,
keeping the r, c of the breaking iteration, exactly like the reference.

Shapes follow a trailing-matrix convention: ``K (..., M, N)``, ``u (..., M)``,
``v (..., N)``.  The leading ``batch_dims`` axes are independent problems
(what ``vmap`` gives the JAX version); the convergence residual is averaged
over every other axis, so a (topk, R, R) stack with ``batch_dims=0`` exits as
one, like the reference's per-query ``.mean()`` over its candidate batch.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _matvec(K: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K @ x over trailing dims: (..., M, N) x (..., N) -> (..., M)."""
    return torch.matmul(K, x.unsqueeze(-1)).squeeze(-1)


def _matvec_t(K: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K^T @ x over trailing dims: (..., M, N) x (..., M) -> (..., N)."""
    return torch.matmul(K.transpose(-1, -2), x.unsqueeze(-1)).squeeze(-1)


def sinkhorn(
    K: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    iters: int = 100,
    thresh: float = 1e-1,
    return_scalings: bool = False,
    batch_dims: int = 0,
):
    """Row/column scaling iterations; returns the transport plan
    T = diag(r) K diag(c).

    Reference utilities/diml.py:42-54: r, c start at ones; ``r = u / (K c)``;
    ``c = v / (K^T r)``; stop updating once ``mean|r - r_prev| < thresh``.
    ``thresh=0.0`` always runs the full ``iters`` iterations.
    """
    K, u, v = K.float(), u.float(), v.float()
    batch = u.shape[:batch_dims]
    red = tuple(range(batch_dims, u.ndim))
    r = torch.ones_like(u)
    c = torch.ones_like(v)
    done = torch.zeros(batch, dtype=torch.bool, device=u.device)
    expand = (1,) * (u.ndim - batch_dims)
    for _ in range(iters):
        d = done.reshape(batch + expand)
        r_new = torch.where(d, r, u / _matvec(K, c))
        c_new = torch.where(d, c, v / _matvec_t(K, r_new))
        err = torch.mean(torch.abs(r_new - r), dim=red)
        done = done | (err < thresh)
        r, c = r_new, c_new
        # frozen problems are no-ops, so stopping once all are frozen is
        # identical to running out the trip count
        if bool(done.all()):
            break
    T = r[..., :, None] * K * c[..., None, :]
    if return_scalings:
        return T, (r, c)
    return T


def extend_dustbin(K: torch.Tensor, u: torch.Tensor, v: torch.Tensor, bin_mass: float):
    """Append the dustbin row + column (kernel value ``bin_mass``, corner 0)
    and the dustbin marginal ``bin_mass``."""
    *batch, m, n = K.shape
    K_ext = K.new_full((*batch, m + 1, n + 1), bin_mass)
    K_ext[..., :m, :n] = K
    K_ext[..., m, n] = 0.0
    u_ext = torch.cat([u, u.new_full((*batch, 1), bin_mass)], dim=-1)
    v_ext = torch.cat([v, v.new_full((*batch, 1), bin_mass)], dim=-1)
    return K_ext, u_ext, v_ext


def sinkhorn_partial(
    K: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    ot_part: float = 0.1,
    iters: int = 100,
    thresh: float = 1e-1,
    batch_dims: int = 0,
) -> torch.Tensor:
    """Partial OT via one dummy dustbin row + column carrying mass
    ``1 - ot_part`` (reference utilities/diml.py:56-75).  Returns the
    *extended* (M+1, N+1) plan; callers crop ``T[..., :M, :N]``."""
    K_ext, u_ext, v_ext = extend_dustbin(K.float(), u.float(), v.float(), 1.0 - ot_part)
    return sinkhorn(K_ext, u_ext, v_ext, iters=iters, thresh=thresh, batch_dims=batch_dims)


def sinkhorn_plan_from_scores(
    S: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    ot_temp: float = 0.05,
    ot_part: float = 1.0,
    iters: int = 100,
    thresh: float = 1e-1,
    batch_dims: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cost = 1 - S, kernel = exp(-cost / ot_temp), then (partial) Sinkhorn.

    Returns ``(T, T_ext)``: T cropped to S's shape and the extended plan when
    ``ot_part < 1`` (otherwise T_ext is T), the shared stage-1 recipe of every
    ``calc_similarity*`` variant (reference utilities/diml.py:101-139).
    """
    K = torch.exp(-(1.0 - S.float()) / ot_temp)
    if ot_part > 0.999:
        T = sinkhorn(K, u, v, iters=iters, thresh=thresh, batch_dims=batch_dims)
        return T, T
    T_ext = sinkhorn_partial(
        K, u, v, ot_part=ot_part, iters=iters, thresh=thresh, batch_dims=batch_dims
    )
    m, n = S.shape[-2], S.shape[-1]
    return T_ext[..., :m, :n], T_ext
