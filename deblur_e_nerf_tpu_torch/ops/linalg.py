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
    maximal pivot, as jnp.argmax picks it)
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


def solve(a, b):
    """Solve a @ x = b for a (..., n, n), b (..., n, m) -> x (..., n, m).

    Unrolled Gaussian elimination with partial pivoting; all arithmetic is
    elementwise over the batch (n and m are small and static)."""
    n, m = a.shape[-1], b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*batch, n, n)
    b = b.expand(*batch, n, m)
    rows = [torch.cat([a[..., i, :], b[..., i, :]], dim=-1)
            for i in range(n)]  # (..., n + m) augmented rows
    for col in range(n):
        mags = torch.stack([rows[r][..., col].abs()
                            for r in range(col, n)])  # (n - col, ...)
        piv = torch.argmax(mags, dim=0)[..., None]  # first maximum
        pivot_row = rows[col]
        for off in range(1, n - col):
            pivot_row = torch.where(piv == off, rows[col + off], pivot_row)
        new_rows = list(rows)
        new_rows[col] = pivot_row
        for off in range(1, n - col):
            new_rows[col + off] = torch.where(piv == off, rows[col],
                                              rows[col + off])
        rows = new_rows
        inv_p = 1.0 / rows[col][..., col]
        for r in range(col + 1, n):
            factor = (rows[r][..., col] * inv_p)[..., None]
            rows[r] = rows[r] - factor * rows[col]
    x = [None] * n
    for i in reversed(range(n)):
        acc = rows[i][..., n:]  # (..., m)
        for j in range(i + 1, n):
            acc = acc - rows[i][..., j, None] * x[j]
        x[i] = acc / rows[i][..., i, None]
    return torch.stack(x, dim=-2)


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
    # per-element 1-norm (max abs column sum); no gradient through s
    norm = a.detach().abs().sum(dim=-2).amax(dim=-1)
    norm = torch.clamp(norm, min=torch.finfo(dtype).tiny)
    s = torch.ceil(torch.log2(norm / _THETA13))
    s = torch.clamp(s, 0, max_squarings).to(torch.int32)
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
