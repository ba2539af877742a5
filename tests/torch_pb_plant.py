"""Planted errors for the weight chain's step-scale accuracy rule
(chip_smoke.pb_accuracy_check), shared by the CPU tests
(test_torch_pb_weight.py) and the card tests (test_torch_cuda.py): a
stand-in for `pb_weight.weight` whose weights, or whose intensities'
cotangent, have one entry set off the float64 chain by a planted amount.
Torch only (the card machine has no jax)."""

import torch

from deblur_e_nerf_tpu_torch.ops import pb_weight

# the planted cases: (what, column, size): the column the float32 plain
# chain is farthest from float64 in ("worst") or nearest ("best", a
# well-conditioned column where there is one), and the planted entry's
# error beyond that column's limit (PB_STEP_FACTOR times the plain
# chain's column error plus the slack), in PB_STEP_FORWARD_ATOL of the
# largest float64 weight (forward) or in tolerances (backward); negative
# within the limit, NaN a NaN entry
PLANTS = {"forward, worst column, 0.5 within": ("forward", "worst", -0.5),
          "forward, worst column, 1 beyond": ("forward", "worst", 1.0),
          "forward, best column, 0.5 within": ("forward", "best", -0.5),
          "forward, best column, 1 beyond": ("forward", "best", 1.0),
          "backward, worst column, 2 beyond": ("backward", "worst", 2.0),
          "backward, best column, 2 beyond": ("backward", "best", 2.0),
          "forward nan": ("forward", "worst", float("nan")),
          "backward nan": ("backward", "worst", float("nan"))}


class _SetGrad(torch.autograd.Function):
    """The identity, whose backward sets one entry of the cotangent."""

    @staticmethod
    def forward(ctx, x, j, value):
        ctx.j, ctx.value = j, value
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g.view(-1)[ctx.j] = ctx.value
        return g, None, None


def planted_entry(references, what, column, size):
    """(the flat index of the planted entry, its value, the planted
    column's float32 plain error and limit) of a plant: in the column of
    the weights (forward) or of the intensities' cotangent (backward) that
    `column` names, the entry of the largest float64 magnitude, set
    (PB_STEP_FACTOR e(plain) + slack + size slack) of its tolerance from
    the float64 value."""
    import chip_smoke

    (w_p, g_p), (w64, g64) = references
    M = g64[0][0].numel()
    if what == "forward":
        got, exact = w_p, w64
        fin = torch.isfinite(exact)
        tol = torch.full_like(exact, float(exact[fin].abs().max()))
        slack = chip_smoke.PB_STEP_FORWARD_ATOL
    else:
        got, exact = g_p[0], g64[0]
        fin = torch.isfinite(exact)
        tol = 1e-3 * exact.abs() + 1e-3 * float(exact[fin].abs().max()) \
            + 1e-300
        slack = chip_smoke.PB_STEP_BACKWARD_SLACK
    e_p = chip_smoke.pb_column_errors(torch, got, exact, tol, M)
    m = int(e_p.argmax() if column == "worst" else e_p.argmin())
    limit = chip_smoke.PB_STEP_FACTOR * float(e_p[m]) + slack
    mags = torch.where(fin, exact.abs(), torch.zeros_like(exact))
    cols = chip_smoke.pb_columns(mags, M)
    row = int(cols[:, m].reshape(cols.shape[0], -1).amax(1).argmax())
    rest = int(cols[row, m].argmax())
    j = (row * M + m) * cols.shape[2] + rest
    if size != size:  # NaN
        return j, float("nan"), float(e_p[m]), limit
    value = float(exact.reshape(-1)[j]) \
        + (limit + size * slack) * float(tol.reshape(-1)[j])
    return j, value, float(e_p[m]), limit


def planted_weight(references, what, column, size):
    """A `pb_weight.weight` stand-in that runs the real one with the entry
    of `planted_entry` set to its planted value."""
    j, value, _, _ = planted_entry(references, what, column, size)
    real = pb_weight.weight
    if what == "forward":
        def weight(params, intensity, dt, n_out):
            # moved by a constant: the weights' gradient is the real one
            w = real(params, intensity, dt, n_out)
            delta = torch.zeros_like(w)
            delta.view(-1)[j] = value - w.detach().view(-1)[j]
            return w + delta
        return weight

    def weight(params, intensity, dt, n_out):
        return real(params, _SetGrad.apply(intensity, j, value), dt, n_out)
    return weight
