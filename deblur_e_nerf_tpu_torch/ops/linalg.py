"""Batched small-matrix linear algebra (counterpart of
deblur_e_nerf_tpu/ops/linalg.py).

The JAX package keeps its matrices matrix-leading, (n, n, batch...), to
fit the TPU's (8, 128) tiles; that was a TPU tiling device, so the port
uses the plain (..., n, n) layout.

Every product here is written as explicit multiply-adds (a broadcast
multiply summed over the contracted axis), never `@`/`bmm`: a float32
`torch.matmul` on the card runs in TF32 as soon as anyone sets
`torch.set_float32_matmul_precision("high")`, and Pade-13's coefficients
(b0 ~ 6.5e16) make the `v - u` cancellation in `expm` sensitive enough
that a reduced-precision product can make the solve singular (the JAX
package forces Precision.HIGHEST for the same reason).

Provides:
  - eye, matmul
  - solve: unrolled Gaussian elimination with partial pivoting (the first
    maximal pivot, as jnp.argmax picks it), built from factor and
    solve_factored; solve_transposed reuses a factorization for a^-T b
    (the weight chain's backward, ops/pb_weight.py)
  - expm: float32-safe Pade-13 scaling-and-squaring with the per-element
    scaling applied before any matrix power. `torch.linalg.matrix_exp` is
    a different algorithm, and the stiff pixel-circuit systems are why the
    JAX package wrote its own.
"""

import torch

_PADE13_B = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0,
    670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
    960960.0, 16380.0, 182.0, 1.0,
)
_THETA13 = 5.371920351148152
MAX_SQUARINGS = 32  # covers ||A|| up to theta13 * 2^32 ~ 2.3e10


def eye(n, dtype=torch.float32, device=None):
    """(n, n) identity, broadcastable over any batch."""
    return torch.eye(n, dtype=dtype, device=device)


def matmul(a, b):
    """(..., i, j) x (..., j, k) -> (..., i, k) as full-precision
    multiply-adds over j (never TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _swap(t, col, piv):
    """Swap list entry col with col + piv (per batch element), in place."""
    old = list(t)
    for off in range(1, len(t) - col):
        t[col] = torch.where(piv == off, old[col + off], t[col])
        t[col + off] = torch.where(piv == off, old[col], old[col + off])


def factor(a):
    """The pivoted Gaussian elimination of a (..., n, n): each column's
    pivot is the first row of largest magnitude at or below the diagonal
    (as jnp.argmax and torch.argmax pick it; a NaN counts as the largest),
    whole rows are swapped, then the rows below are eliminated. Returns
    (the eliminated rows, whose upper triangle is U; each column's pivot
    offset (..., 1); each column's multipliers (..., 1) for the rows
    below it). n is small and static; all arithmetic is elementwise over
    the batch."""
    n = a.shape[-1]
    rows = [a[..., i, :] for i in range(n)]
    pivots, factors = [], []
    for col in range(n):
        mags = torch.stack([rows[r][..., col].abs()
                            for r in range(col, n)])  # (n - col, ...)
        piv = torch.argmax(mags, dim=0)[..., None]  # first maximum
        _swap(rows, col, piv)
        inv_p = 1.0 / rows[col][..., col]
        f = []
        for r in range(col + 1, n):
            f.append((rows[r][..., col] * inv_p)[..., None])
            rows[r] = rows[r] - f[-1] * rows[col]
        pivots.append(piv)
        factors.append(f)
    return rows, pivots, factors


def solve_factored(fac, b):
    """a^-1 b for b (..., n, m) from `factor(a)`: each column's swap and
    eliminations on b's rows, then back substitution."""
    rows, pivots, factors = fac
    n = len(rows)
    t = [b[..., i, :] for i in range(n)]
    for col in range(n):
        _swap(t, col, pivots[col])
        for k, r in enumerate(range(col + 1, n)):
            t[r] = t[r] - factors[col][k] * t[col]
    x = [None] * n
    for i in reversed(range(n)):
        acc = t[i]  # (..., m)
        for j in range(i + 1, n):
            acc = acc - rows[i][..., j, None] * x[j]
        x[i] = acc / rows[i][..., i, None]
    return torch.stack(x, dim=-2)


def solve_transposed(fac, b):
    """a^-T b for b (..., n, m) from `factor(a)`: the transpose of
    `solve_factored`'s steps in reverse (U^T t = b by forward
    substitution, then each column's eliminations and swap transposed,
    the last column first). With a's own pivots the result is the
    transpose of the forward's arithmetic, as autograd's adjoint of a
    solve is."""
    rows, pivots, factors = fac
    n = len(rows)
    t = [None] * n
    for i in range(n):
        acc = b[..., i, :]
        for j in range(i):
            acc = acc - rows[j][..., i, None] * t[j]
        t[i] = acc / rows[i][..., i, None]
    for col in reversed(range(n)):
        for k, r in enumerate(range(col + 1, n)):
            t[col] = t[col] - factors[col][k] * t[r]
        _swap(t, col, pivots[col])
    return torch.stack(t, dim=-2)


def solve(a, b):
    """Solve a @ x = b for a (..., n, n), b (..., n, m) -> x (..., n, m):
    unrolled Gaussian elimination with partial pivoting."""
    return solve_factored(factor(a), b)


def squaring_count(a, max_squarings=MAX_SQUARINGS):
    """`expm`'s per-element squaring count s (int32, no gradient): the
    per-element 1-norm (largest column sum of magnitudes) over theta_13,
    rounded up to a power of two, clipped to [0, max_squarings]; 0 where
    the norm is NaN."""
    norm = a.detach().abs().sum(dim=-2).amax(dim=-1)
    norm = torch.clamp(norm, min=torch.finfo(a.dtype).tiny)
    s = torch.nan_to_num(torch.ceil(torch.log2(norm / _THETA13)), nan=0.0)
    return torch.clamp(s, 0, max_squarings).to(torch.int32)


def expm(a, max_squarings=MAX_SQUARINGS):
    """Matrix exponential of (..., n, n).

    The squarings run up to the batch's largest squaring count `s`: each
    element is squared exactly its own `s` times (`torch.where`), so the
    value and gradient equal the JAX package's fixed `max_squarings` loop,
    whose later iterations are identities. Reading that count costs one
    device-to-host copy."""
    dtype = a.dtype
    n = a.shape[-1]
    eye_n = eye(n, dtype, a.device)
    s = squaring_count(a, max_squarings)
    a = a * torch.exp2(-s.to(dtype))[..., None, None]

    b = _PADE13_B
    a2 = matmul(a, a)
    a4 = matmul(a2, a2)
    a6 = matmul(a2, a4)
    u = matmul(a, (
        matmul(a6, b[13] * a6 + b[11] * a4 + b[9] * a2)
        + b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * eye_n
    ))
    v = (
        matmul(a6, b[12] * a6 + b[10] * a4 + b[8] * a2)
        + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * eye_n
    )
    phi = solve(v - u, v + u)
    n_squarings = int(s.max()) if s.numel() else 0
    for i in range(n_squarings):
        phi = torch.where((i < s)[..., None, None], matmul(phi, phi), phi)
    return phi
