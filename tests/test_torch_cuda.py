"""CUDA kernels of the port against their plain PyTorch versions, on a
CUDA card only (skipped here otherwise). This file imports neither jax
nor the JAX package, so it runs on the GPU machine, where jax is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from deblur_e_nerf_tpu_torch.models import contraction, fields, hash_encoding
from deblur_e_nerf_tpu_torch.ops import (compact, composite, gather_rows,
                                         hash_encode, pb_weight,
                                         scatter_rows)
from torch_pb_plant import PLANTS, planted_entry, planted_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,n_rows,width", [
    (524289, 65536, 16),     # cellhash levels of the flagship step
    (524289, 4096, 16),      # dense level 0 (heavy collisions)
    (4194312, 524288, 2),    # vertex-hash levels, 8 corners per sample
    (1000, 7, 16),           # tiny, ragged
])
def test_scatter_kernel_matches_plain(cuda, n, n_rows, width):
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, n_rows, n).astype(np.int32))
    val = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32))
    i, v = idx.to(cuda), val.to(cuda)
    before = scatter_rows.LAUNCHES
    out = scatter_rows.scatter_add_rows(i, v, n_rows)
    torch.cuda.synchronize()
    assert scatter_rows.LAUNCHES == before + 1
    exact = scatter_rows.scatter_add_rows_reference(idx, val, n_rows,
                                                    dtype=torch.float64)
    # any order of k f32 additions is within (k - 1) eps sum|x| of exact
    counts = np.bincount(idx.numpy(), minlength=n_rows)
    abs_sum = scatter_rows.scatter_add_rows_reference(
        idx, val.abs(), n_rows, dtype=torch.float64)
    bound = max(counts.max() - 1, 1) * np.finfo(np.float32).eps \
        * float(abs_sum.max())
    assert float((out.cpu().double() - exact).abs().max()) <= bound


K1_KINDS = ["uniform", "empty_tail", "ray_runs", "one_run", "all_zero",
            "signed_zeros", "nonfinite", "out_of_range"]


@pytest.mark.parametrize("width", [1, 2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("kind", K1_KINDS)
def test_scatter_kernel_matches_plain_and_model(cuda, kind, width):
    """The kernel against index_add_, the plain model of its summation
    order and float64, through chip_smoke's check: 2 (k - 1) eps sum|x|
    for a row of k non-zero contributions, non-finite entries exactly
    (NaN and infinities reach the table as index_add_ puts them there),
    out-of-range indices add nothing. 20,001 rows: every vector path, the
    ragged last row group, a long run of one index, +-0 rows."""
    n, n_rows = 20001, 997
    idx, val = chip_smoke.k1_inputs(kind, n, n_rows, width, seed=width)
    i = torch.from_numpy(idx).to(cuda)
    v = torch.from_numpy(val).to(cuda)
    before = scatter_rows.LAUNCHES
    out = scatter_rows.scatter_add_rows(i, v, n_rows)
    torch.cuda.synchronize()
    assert scatter_rows.LAUNCHES == before + 1
    errs, tol = chip_smoke.k1_check(torch, out, i, v, n_rows, kind)
    assert max(errs) <= tol
    if kind in ("empty_tail", "all_zero", "signed_zeros"):
        # skipped zero rows leave +0.0, as index_add_ from +0.0 does
        plain = scatter_rows.scatter_add_rows_reference(
            i[(i >= 0) & (i < n_rows)], v[(i >= 0) & (i < n_rows)], n_rows)
        zero = plain == 0
        assert not bool(torch.signbit(out[zero]).any())


@pytest.mark.parametrize("width", [2, 16])
def test_scatter_kernel_rejects_misaligned_views(cuda, width):
    """A contiguous view 4 bytes into its storage cannot take the float2 /
    float4 chunks: the wrapper raises instead of falling back."""
    buf = torch.zeros(64 * width + 1, device=cuda)
    val = buf[1:].view(64, width)
    assert val.is_contiguous()
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    before = scatter_rows.LAUNCHES
    with pytest.raises(ValueError, match="aligned"):
        scatter_rows.scatter_add_rows(idx, val, 3)
    assert scatter_rows.LAUNCHES == before


def test_scatter_kernel_long_run_at_main_path_width(cuda):
    """2^20 rows at one index (the empty-slot pile-up, with values): one
    atomic per 8-row group, the sum within the stated bound."""
    n, n_rows, width = 1 << 20, 4096, 16
    idx, val = chip_smoke.k1_inputs("one_run", n, n_rows, width, seed=7)
    i = torch.from_numpy(idx).to(cuda)
    v = torch.from_numpy(val).to(cuda)
    out = scatter_rows.scatter_add_rows(i, v, n_rows)
    torch.cuda.synchronize()
    errs, tol = chip_smoke.k1_check(torch, out, i, v, n_rows, "long run")
    assert max(errs) <= tol


def test_scatter_wrapper_raises_instead_of_falling_back(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        scatter_rows.scatter_add_rows(idx, torch.zeros(
            (4, 2), dtype=torch.float64, device=cuda), 3)
    with pytest.raises(ValueError):
        scatter_rows.scatter_add_rows(idx, torch.zeros(
            (2, 8), device=cuda)[:, ::2], 3)


def test_field_table_grad_on_card_matches_cpu(cuda):
    """The NGP field's outputs and table gradient through the kernel
    against the plain version on the CPU (bf16 gathers in both)."""
    outs = {}
    for device in ("cpu", cuda):
        gen = torch.Generator().manual_seed(1)
        field = fields.NGPField(
            aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
            contraction_type=contraction.ContractionType.AABB,
            radiance_dim=1, pos_otype="HybridHashGrid", n_levels=8,
            log2_hashmap_size=12, base_resolution=4, per_level_scale=2.0,
            grid_compute_dtype="bfloat16", generator=gen)
        with torch.no_grad():
            field.table.uniform_(-1.0, 1.0, generator=gen)
        field = field.to(device)
        gen = torch.Generator().manual_seed(2)
        x = (torch.rand((4096, 3), generator=gen) * 3.2 - 1.6).to(device)
        d = torch.nn.functional.normalize(
            torch.randn((4096, 3), generator=gen), dim=-1).to(device)
        rgb, sigma = field(x, d)
        (rgb.sum() + sigma.sum()).backward()
        outs[str(device)] = [t.detach().cpu()
                             for t in (rgb, sigma, field.table.grad)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        # f32 sums in another order (atomics on the card)
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("round_to", [None, torch.bfloat16])
@pytest.mark.parametrize("n,n_rows,width", [
    (524289, 65536, 16),     # cellhash view of the flagship step
    (524289, 343000, 16),    # packed dense level 4
    (4194312, 524288, 2),    # vertex-hash levels, 8 corners per sample
    (1000, 7, 16),           # tiny, ragged
    (999, 13, 3),            # odd width: the generic path
    (1001, 100, 2),          # W = 2, N not a multiple of 4 or 8
    (259, 50, 2),            # W = 2, one warp tile and a 3-row tail
    (4194311, 524288, 2),    # W = 2, a ragged tail at the real size
    (1003, 50, 16),          # W = 16, N not a multiple of 4 or 8
    (1000, 40, 8),           # a width with no instance of its own
])
def test_gather_kernel_matches_plain_bit_for_bit(cuda, n, n_rows, width,
                                                  round_to):
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, n_rows, n).astype(np.int32))
    tbl = torch.from_numpy(rng.normal(size=(n_rows, width)).astype(
        np.float32))
    before = gather_rows.LAUNCHES
    out = gather_rows.gather_rows(tbl.to(cuda), idx.to(cuda), round_to)
    torch.cuda.synchronize()
    assert gather_rows.LAUNCHES == before + 1
    want = gather_rows.gather_rows_reference(tbl, idx, round_to)
    # bf16 rows out when rounding, float32 rows otherwise
    assert out.dtype == want.dtype == (round_to or torch.float32)
    assert torch.equal(chip_smoke._bits(torch, out.cpu()),
                       chip_smoke._bits(torch, want))


def test_gather_kernel_on_a_segment_view(cuda):
    """The encode gathers from row slices of the table (a level's
    segment, the cellhash (T/8, 8F) view): offsets that are not 16-byte
    aligned take the narrower path."""
    tbl = torch.randn((4099, 2), device=cuda)
    idx = torch.randint(0, 1000, (5000,), dtype=torch.int32, device=cuda)
    for offset in (0, 1, 3, 128):
        seg = tbl[offset:offset + 1000]
        out = gather_rows.gather_rows(seg, idx, torch.bfloat16)
        assert torch.equal(out, gather_rows.gather_rows_reference(
            seg, idx, torch.bfloat16))


@pytest.mark.parametrize("round_to", [None, torch.bfloat16])
@pytest.mark.parametrize("width", [2, 16])
def test_gather_kernel_on_an_unaligned_index_view(cuda, width, round_to):
    """An index vector that starts 4, 8 or 12 bytes past a 16-byte
    boundary (a contiguous view at an offset): the W = 2 instance reads
    its indices as scalars instead of int4."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    tbl = torch.randn((5000, width), generator=gen, device=cuda)
    base = torch.randint(0, 5000, (70000,), generator=gen,
                         dtype=torch.int32, device=cuda)
    for offset in (1, 2, 3, 4):
        idx = base[offset:offset + 66000 - offset]
        assert idx.is_contiguous() and (idx.data_ptr() % 16 != 0) == (
            offset % 4 != 0)
        out = gather_rows.gather_rows(tbl, idx, round_to)
        want = gather_rows.gather_rows_reference(tbl, idx, round_to)
        assert torch.equal(chip_smoke._bits(torch, out),
                           chip_smoke._bits(torch, want))


@pytest.mark.parametrize("otype,layout", [
    ("HybridHashGrid", (8, 4, 2.0, 12)),
    ("HashGrid", (8, 4, 2.0, 12)),
    ("TiledGrid", (8, 4, 2.0, 12)),
    ("CellHashGrid", (8, 4, 2.0, 12)),
    ("DenseGrid", (3, 4, 2.0, 12)),
])
def test_encode_on_card_matches_cpu(cuda, otype, layout):
    """The encode's features (bf16 rows through the fused forward) and
    table gradient (the fused backward) on the card against the plain
    version on the CPU: the gathered values agree bit for bit, the 8-term
    float32 sums and the row sums may run in another order."""
    levels, total = hash_encoding.grid_layout(otype, *layout)
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.uniform(-1, 1, (total, 2)).astype(
        np.float32))
    u = torch.from_numpy(rng.uniform(-0.05, 1.05, (20000, 3)).astype(
        np.float32))
    cot = torch.from_numpy(rng.normal(size=(20000, 2 * len(levels))).astype(
        np.float32))
    outs = {}
    for device in ("cpu", cuda):
        t = table.to(device, copy=True).requires_grad_(True)
        before = (hash_encode.FORWARD_LAUNCHES,
                  hash_encode.BACKWARD_LAUNCHES, gather_rows.LAUNCHES,
                  scatter_rows.LAUNCHES)
        feat = hash_encoding.encode(t, u.to(device), levels,
                                    compute_dtype=torch.bfloat16)
        (feat * cot.to(device)).sum().backward()
        if device == cuda:  # one launch a direction, over all levels
            assert (hash_encode.FORWARD_LAUNCHES,
                    hash_encode.BACKWARD_LAUNCHES, gather_rows.LAUNCHES,
                    scatter_rows.LAUNCHES) == (before[0] + 1, before[1] + 1,
                                               before[2], before[3])
        outs[str(device)] = (feat.detach().cpu(), t.grad.cpu())
    # tests/test_torch_hash_encoding.py's tolerances against the JAX encode
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    scale = float(outs["cpu"][1].abs().max())
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=1e-4,
                               atol=1e-5 * scale)


ENCODE_OTYPES = [("HybridHashGrid", (8, 4, 2.0, 12)),
                 ("HashGrid", (8, 4, 2.0, 12)),
                 ("TiledGrid", (8, 4, 2.0, 12)),
                 ("CellHashGrid", (8, 4, 2.0, 12)),
                 ("DenseGrid", (3, 4, 2.0, 12))]


def _x_runs(levels, n, gen, cuda):
    """Runs of 32 samples along x at half a cell of the finest vertex
    level, from uniform starts: lanes of a warp share rows, and about half
    of the x-neighbour corner pairs lie in one aligned row pair (a hash
    level's pairs are the even x cells)."""
    res = max(r for r, _, _, m in levels if m != "cellhash")
    n_runs = -(-n // 32)
    start = torch.rand((n_runs, 1, 3), generator=gen, device=cuda)
    step = torch.arange(32, device=cuda)[None, :, None] * torch.tensor(
        [0.5 / res, 0.0, 0.0], device=cuda)
    u = (start + step).reshape(-1, 3)[:n].contiguous()
    return u, torch.ones(n, dtype=torch.bool, device=cuda)


def _encode_inputs(cuda, otype, layout, n, kind="uniform", seed=0,
                   levels=None):
    if levels is None:
        levels, total = hash_encoding.grid_layout(otype, *layout)
    else:
        total = max(o + s for _, s, o, _ in levels)
        total += total % 2
    gen = torch.Generator(device=cuda).manual_seed(seed)
    table = torch.rand((total, 2), generator=gen, device=cuda) * 2 - 1
    if kind == "x_runs":
        u, live = _x_runs(levels, n, gen, cuda)
    else:
        u, live = chip_smoke.encode_positions(torch, kind, n, gen, cuda)
    # the cube's corners and faces, and beyond it: u = 1.0 is a dense
    # level's clipped last cell (frac = 1.0)
    u[:16] = torch.round(u[:16])
    u[16:32, 0] = 1.0
    u[32:48] = 1.25
    g = torch.randn((n, 2 * len(levels)), generator=gen, device=cuda) \
        * live[:, None]
    return levels, total, table, u, g


def _check_half_paired(levels, u):
    """The x_runs case as built: on every vertex level between a fifth and
    four fifths of the corner pairs share a row pair."""
    uc = torch.clamp(u, 0.0, 1.0)
    for level in levels:
        if level[3] != "cellhash":
            rows, _ = hash_encode.level_rows_weights(uc, *level,
                                                     torch.float32)
            share = float(hash_encode.x_pairs(rows).float().mean())
            assert 0.2 < share < 0.8, (level, share)


ENCODE_KINDS = [(100003, "uniform"), (37, "uniform"), (100003, "rays"),
                (100003, "x_runs")]


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("n,kind", ENCODE_KINDS)
@pytest.mark.parametrize("otype,layout", ENCODE_OTYPES)
def test_encode_forward_kernel_matches_its_model_bit_for_bit(
        cuda, otype, layout, n, kind, compute_dtype):
    """The fused forward against the plain model of its order (products
    rounded, corners summed k = 0..7) bit for bit, for every mode, both
    row types (bf16 through the wrapper's bf16 copy of the table), a
    ragged N and one below a block, on uniform positions, ray-ordered
    samples and runs along x with half the x-pairs in one row pair."""
    levels, _, table, u, _ = _encode_inputs(cuda, otype, layout, n, kind)
    if kind == "x_runs":
        _check_half_paired(levels, u)
    before = hash_encode.FORWARD_LAUNCHES
    out = hash_encode.encode_forward(table, u, levels, compute_dtype)
    torch.cuda.synchronize()
    assert hash_encode.FORWARD_LAUNCHES == before + 1
    model = hash_encode.encode_forward_model(table, u, levels, compute_dtype)
    assert out.dtype == torch.float32 and out.shape == model.shape
    assert torch.equal(chip_smoke._bits(torch, out),
                       chip_smoke._bits(torch, model))


@pytest.mark.parametrize("kind", ["uniform", "rays", "x_runs"])
@pytest.mark.parametrize("otype,layout", ENCODE_OTYPES)
def test_encode_backward_kernel_within_the_order_bound(cuda, otype, layout,
                                                        kind):
    """The fused backward against the float64 sum of the same float32
    contributions: every row within (k - 1) eps sum|x| + k FLT_MIN, k its
    count of non-zero contributions (chip_smoke's check), on uniform
    positions, on
    ray-ordered samples with an empty-slot tail and on runs along x with
    half the x-pairs in one row pair."""
    levels, total, _, u, g = _encode_inputs(cuda, otype, layout, 200003,
                                            kind)
    if kind == "x_runs":
        _check_half_paired(levels, u)
    before = hash_encode.BACKWARD_LAUNCHES
    grad = hash_encode.encode_backward(g, u, levels, total)
    torch.cuda.synchronize()
    assert hash_encode.BACKWARD_LAUNCHES == before + 1
    assert grad.dtype == torch.float32 and grad.shape == (total, 2)
    _, within, max_k, _ = chip_smoke.check_encode_backward(torch, grad, g, u,
                                                           levels)
    assert within and max_k > 1


def _odd_sized_levels():
    """HashGrid's layout with its last two levels resized: a hash level
    of 1001 rows and a tiled one of 1000 (neither a power of two)."""
    levels, _ = hash_encoding.grid_layout("HashGrid", 8, 4, 2.0, 12)
    (r1, _, o1, _), (r2, _, o2, _) = levels[-2:]
    return levels[:-2] + [(r1, 1001, o1, "hash"), (r2, 1000, o2, "tiled")]


@pytest.mark.parametrize("kind", ["uniform", "x_runs"])
def test_encode_kernels_on_non_power_of_two_level_sizes(cuda, kind):
    """A hash level of an odd size (its x-pairs no longer follow x's
    parity) and a tiled level of 1000 rows (the flat index wraps): the
    forward bit for bit with its model in both row types, the backward
    within its per-row bound."""
    levels = _odd_sized_levels()
    _, total, table, u, g = _encode_inputs(cuda, None, None, 100003, kind,
                                           levels=levels)
    for compute_dtype in (None, torch.bfloat16):
        out = hash_encode.encode_forward(table, u, levels, compute_dtype)
        model = hash_encode.encode_forward_model(table, u, levels,
                                                 compute_dtype)
        assert torch.equal(chip_smoke._bits(torch, out),
                           chip_smoke._bits(torch, model))
    grad = hash_encode.encode_backward(g, u, levels, total)
    _, within, max_k, _ = chip_smoke.check_encode_backward(torch, grad, g, u,
                                                           levels)
    assert within and max_k > 1


def test_encode_backward_nan_and_inf_reach_the_table(cuda):
    """NaN and +-inf cotangents reach every row they touch, through the
    cellhash levels' bulk reductions and the vertex levels' F32x4 and
    F32x2: the NaN and inf pattern (and the sign of each inf) of the
    gradient is the float64 plain version's, which no summation order
    changes; every finite row stays within its bound."""
    levels, total, _, u, g = _encode_inputs(cuda, "HybridHashGrid",
                                            (8, 4, 2.0, 12), 20003, "rays")
    assert {m for *_, m in levels} == {"dense", "hash", "cellhash"}
    g[100, :] = float("nan")
    g[2000, ::2] = float("inf")
    g[5000, 1::2] = float("-inf")
    g[7000, :] = float("inf")
    g[7001, :] = float("-inf")
    grad = hash_encode.encode_backward(g, u, levels, total)
    want = hash_encode.encode_backward_reference(g, u, levels, total,
                                                 sum_dtype=torch.float64)
    assert bool(torch.isnan(want).any() and torch.isinf(want).any())
    assert torch.equal(torch.isnan(grad), torch.isnan(want))
    assert torch.equal(torch.isinf(grad), torch.isinf(want))
    inf = torch.isinf(want)
    assert torch.equal(grad[inf] > 0, want[inf] > 0)
    finite = torch.isfinite(want).all(-1)
    exact = hash_encode.encode_backward_reference(
        torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0), u, levels,
        total, sum_dtype=torch.float64)
    assert torch.allclose(grad[finite].double(), exact[finite], rtol=1e-4,
                          atol=1e-4)


def test_encode_bf16_copy_is_reused_until_an_optimizer_step(cuda):
    """The wrapper's bf16 copy of the table: made once for two forwards
    without an optimizer step, made again after one (the port's
    optimizer writes the table in place); each forward bit for bit with
    its model on the current table."""
    from deblur_e_nerf_tpu_torch.training.optim import Optimizer

    levels, _, table, u, g = _encode_inputs(cuda, "HybridHashGrid",
                                            (8, 4, 2.0, 12), 4099)
    t = torch.nn.Parameter(table)
    opt = Optimizer([("default", 1e-2, 0.0, [("table", t)])], [], 1.0)
    copies, launches = hash_encode.BF16_COPIES, hash_encode.FORWARD_LAUNCHES

    def forward():
        out = hash_encoding.encode(t, u, levels, compute_dtype=torch.bfloat16)
        model = hash_encode.encode_forward_model(t.detach(), u, levels,
                                                 torch.bfloat16)
        assert torch.equal(chip_smoke._bits(torch, out.detach()),
                           chip_smoke._bits(torch, model))
        return out

    forward()
    (forward() * g).sum().backward()
    assert hash_encode.BF16_COPIES == copies + 1
    opt.step()
    forward()
    assert hash_encode.BF16_COPIES == copies + 2
    assert hash_encode.FORWARD_LAUNCHES == launches + 3


def test_encode_wrappers_raise_instead_of_falling_back(cuda):
    levels, total = hash_encoding.grid_layout("HybridHashGrid", 8, 4, 2.0,
                                              12)
    table = torch.zeros((total, 2), device=cuda)
    u = torch.zeros((64, 3), device=cuda)
    g = torch.zeros((64, 16), device=cuda)
    with pytest.raises(TypeError):
        hash_encode.encode_forward(table.half(), u, levels)
    with pytest.raises(TypeError):
        hash_encode.encode_forward(table, u.double(), levels)
    with pytest.raises(ValueError):  # not 16-byte aligned
        hash_encode.encode_forward(
            torch.zeros(2 * total + 2, device=cuda)[2:].view(total, 2), u,
            levels)
    with pytest.raises(ValueError):  # not contiguous
        hash_encode.encode_forward(table, torch.zeros(
            (64, 6), device=cuda)[:, ::2], levels)
    with pytest.raises(ValueError):  # F = 4 has no instance
        hash_encode.encode_forward(torch.zeros((total, 4), device=cuda), u,
                                   levels)
    with pytest.raises(ValueError):  # positions on another device
        hash_encode.encode_forward(table, u.cpu(), levels)
    with pytest.raises(ValueError):  # more levels than the kernel holds
        many, rows = hash_encoding.grid_layout("DenseGrid", 33, 1, 1.0, 12)
        hash_encode.encode_forward(torch.zeros((rows, 2), device=cuda), u,
                                   many)
    with pytest.raises(ValueError):  # the kernels read row pairs
        hash_encode.encode_forward(torch.zeros((total + 1, 2), device=cuda),
                                   u, levels)
    with pytest.raises(ValueError):
        hash_encode.encode_backward(g, u, levels, total + 1)
    with pytest.raises(TypeError):
        hash_encode.encode_backward(g.half(), u, levels, total)
    with pytest.raises(ValueError):  # not 8-byte aligned
        hash_encode.encode_backward(
            torch.zeros(64 * 16 + 1, device=cuda)[1:].view(64, 16), u,
            levels, total)


def test_gather_wrapper_raises_instead_of_falling_back(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gather_rows.gather_rows(torch.zeros((4, 2), dtype=torch.float64,
                                            device=cuda), idx)
    with pytest.raises(TypeError):
        gather_rows.gather_rows(torch.zeros((4, 2), device=cuda), idx,
                                torch.float16)
    with pytest.raises(ValueError):
        gather_rows.gather_rows(torch.zeros((4, 8), device=cuda)[:, ::2],
                                idx)


def test_filter_on_step_on_card_matches_cpu(cuda, tmp_path):
    """One small filter-on step (S = 30) on the card against the CPU:
    loss and every gradient, within chip_smoke's stated tolerances."""
    rows = chip_smoke.filter_on_step_card_vs_cpu(torch, str(tmp_path))
    assert len(rows) > 10 and all(err <= tol for _, err, tol in rows)


def test_eds_step_on_card_matches_cpu(cuda, tmp_path):
    """One small EDS step (sphere, cone 0.004, float32 HashGrid gathers,
    the trainable filter at S = 30, a distorted calibration) on the card
    against the CPU, within chip_smoke's stated tolerances."""
    rows = chip_smoke.eds_step_card_vs_cpu(torch, str(tmp_path))
    assert len(rows) > 10 and all(err <= tol for _, err, tol in rows)


def test_two_gloo_ranks_on_one_card_match_the_single_process(cuda,
                                                             tmp_path):
    """Two ranks over gloo, both on cuda:0 (`--mesh 2 --dist-backend
    gloo`), take one small filter-on step (S = 30) through the command
    line with the replica check (equal digests), equal to a single-process
    step on the card within chip_smoke.py phase 10's tolerances, each rank
    launching the fused encode's forward and backward, one weight-chain
    forward and backward (and neither K1 nor K3, which no path
    launches)."""
    from deblur_e_nerf_tpu_torch.data import synthetic

    root = synthetic.make_dataset(str(tmp_path / "small"), img_height=16,
                                  img_width=16, num_poses=21)
    launches = chip_smoke.mesh_vs_single(
        torch, str(tmp_path), chip_smoke.small_config(root, filter_on=True),
        "small", steps=1, capacity=8, sample_budget=1 << 19,
        evaluate=False, resume=False)
    assert set(launches) == {"rank 0", "rank 1"}
    for rank, counts in launches.items():
        chip_smoke.check_path_launches(rank, counts, trains=True,
                                       filter_steps=1)


def test_ray_generation_on_card_is_bit_equal_over_batch_shares(cuda,
                                                               tmp_path):
    """The flagship step's ray generation on the card ((S, R x events) =
    (30, 4 x 8192) timestamps): every ray's position, orientation and
    direction computed over one of 2 or 4 ranks' shares of the events is
    bit-equal to the whole batch's (a data-parallel rank computes its
    share alone)."""
    from deblur_e_nerf_tpu_torch.data import synthetic
    from deblur_e_nerf_tpu_torch.training import setup

    root = synthetic.make_dataset(str(tmp_path / "small"), img_height=16,
                                  img_width=16, num_poses=21)
    bundle, _ = setup.build(chip_smoke.small_config(root, filter_on=True),
                            root, device=cuda)
    for world in (2, 4):
        counts = chip_smoke.ray_split_mismatches(torch, bundle.consts, 8192,
                                                 30, 4, world)
        assert counts == {"position": 0, "orientation": 0,
                          "direction": 0}, (world, counts)


def test_eval_render_on_card_matches_cpu(cuda, tmp_path):
    """The eval render of a small model on the card against the CPU: the
    same marched samples per pixel, the image within 1e-5."""
    rows = chip_smoke.eval_render_card_vs_cpu(torch, str(tmp_path))
    assert all(err <= tol for _, err, tol in rows)


@pytest.mark.parametrize("round_to", [None, torch.bfloat16])
@pytest.mark.parametrize("n,n_rows,width", [
    (1 << 20, 65536, 16),       # an eval field call's cellhash levels
    (8 << 20, 524288, 2),       # its vertex-hash levels, 8 corners each
])
def test_kernels_at_the_eval_field_chunk_bit_for_bit(cuda, n, n_rows, width,
                                                     round_to):
    """K3 at the shapes the per-level encode gave it in an eval field call
    (N = 2^20 samples, no gradient): bit for bit against its plain
    version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n_rows)
    table = torch.randn((n_rows, width), generator=gen, device=cuda)
    idx = chip_smoke.k3_indices(torch, "uniform", n, n_rows)
    with torch.no_grad():
        rows = gather_rows.gather_rows(table, idx, round_to)
        plain = gather_rows.gather_rows_reference(table, idx, round_to)
        assert torch.equal(chip_smoke._bits(torch, rows),
                           chip_smoke._bits(torch, plain))


def test_eval_render_with_prepass_on_card_matches_cpu(cuda, tmp_path):
    rows = chip_smoke.eval_render_card_vs_cpu(torch, str(tmp_path),
                                              prepass_div=2)
    assert all(err <= tol for _, err, tol in rows)


def _card_and_cpu(make, cuda):
    gen = torch.Generator().manual_seed(4)
    field = make(gen)
    card = make(torch.Generator().manual_seed(4)).to(cuda)
    card.load_state_dict(field.state_dict())
    return field, card


def _ngp(gen):
    field = fields.NGPField(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
        contraction_type=contraction.ContractionType.AABB, radiance_dim=3,
        pos_otype="HybridHashGrid", n_levels=6, base_resolution=4,
        per_level_scale=2.0, log2_hashmap_size=10, base_n_neurons=16,
        head_n_neurons=16, generator=gen)
    with torch.no_grad():
        field.table.uniform_(-1.0, 1.0, generator=gen)
        field.mlp_base.output.bias[0] += 3.0  # rays terminate
    return field


@pytest.mark.parametrize("field_chunk", [0, 1000])
def test_prepass_render_on_card_matches_cpu(cuda, field_chunk):
    """render_rays with the occlusion prepass (div 2), chunked or not, on
    the card (through the kernels) against the CPU: the same marched
    samples and live demand, outputs within 1e-5, every field gradient
    within 2e-3 of its largest entry (the card-vs-CPU step tolerance)."""
    from deblur_e_nerf_tpu_torch.models import renderer

    cpu_field, card_field = _card_and_cpu(_ngp, cuda)
    rc = renderer.RenderConfig(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
        contraction_type=contraction.ContractionType.AABB,
        grid_resolution=16, near_plane=0.0, far_plane=None,
        render_step_size=0.02, stratified=True, max_samples_per_ray=256,
        sample_budget=8192, prepass_div=2, field_chunk=field_chunk)
    rng = np.random.default_rng(3)
    o = rng.uniform(-3, -2, (48, 3)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (48, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    binary = rng.uniform(size=16 ** 3) < 0.5
    jitter = rng.uniform(size=48).astype(np.float32)
    w = rng.normal(size=(48, 4)).astype(np.float32)
    out = {}
    for name, field, device in (("cpu", cpu_field, torch.device("cpu")),
                                ("card", card_field, cuda)):
        args = [torch.from_numpy(a).to(device)
                for a in (binary, o, d, np.ones(48, bool), jitter, w)]
        res = renderer.render_rays(
            renderer.SplitField(field.encode, field.decode), *args[:5], rc,
            density_only_fn=field.density)
        wt = args[5]
        ((res["radiance"] * wt[:, :3]).sum()
         + (res["opacity"] * wt[:, 3]).sum()).backward()
        out[name] = ({k: v.detach().cpu() for k, v in res.items()},
                     {n: p.grad.detach().double().cpu()
                      for n, p in field.named_parameters()})
    (res_c, grads_c), (res_g, grads_g) = out["cpu"], out["card"]
    assert torch.equal(res_g["counts"], res_c["counts"])
    assert int(res_g["num_marched_samples"]) \
        == int(res_c["num_marched_samples"])
    assert float(res_g["prepass_overflow_rate"]) \
        == float(res_c["prepass_overflow_rate"])
    assert int(res_c["num_rendering_samples"]) \
        < int(res_c["num_marched_samples"])  # the prepass culled
    for k in ("radiance", "opacity", "depth"):
        assert float((res_g[k] - res_c[k]).abs().max()) <= 1e-5, k
    for n, g in grads_c.items():
        assert float((grads_g[n] - g).abs().max()) \
            <= 2e-3 * float(g.abs().max()) + 1e-12, n


def test_optical_depth_backward_on_card_matches_cpu(cuda):
    """ROADMAP Queue C 7/8: composite on a buffer of 2^17 slots (~82k
    samples of 400 rays of 150-259 samples, then empty slots) on the card
    against the CPU. The optical depth and the segment sums use no
    atomics: two card runs give bit-identical outputs and gradients
    (tolerance 0); card and CPU
    agree within 1e-5 of the largest gradient entry (their libm and
    float64 cumsum orders differ; 1.4e-6 measured on an H100), outputs
    within 1e-5."""
    from deblur_e_nerf_tpu_torch.models import renderer

    rng = np.random.default_rng(11)
    R, K1 = 400, 1 << 17
    counts = rng.integers(150, 260, R)
    n = int(counts.sum())
    rc = renderer.RenderConfig(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
        contraction_type=contraction.ContractionType.AABB,
        grid_resolution=16, near_plane=0.0, far_plane=None,
        render_step_size=0.02, early_stop_eps=1e-4)
    data = {
        "t_mid": rng.uniform(1.0, 5.0, K1).astype(np.float32),
        "dt": np.concatenate([rng.uniform(0.005, 0.02, n),
                              np.zeros(K1 - n)]).astype(np.float32),
        "ray_idx": np.concatenate([np.repeat(np.arange(R), counts),
                                   np.full(K1 - n, R)]),
        "sigma": rng.uniform(0, 3, K1).astype(np.float32),
        "rgb": rng.uniform(0, 1, (K1, 3)).astype(np.float32),
        "w": rng.normal(size=(R, 5)).astype(np.float32)}

    def run(device):
        t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        samples = renderer.RaySamples(
            t_mid=t["t_mid"], dt=t["dt"], ray_idx=t["ray_idx"],
            counts=torch.from_numpy(counts).to(device),
            offsets=torch.from_numpy(np.cumsum(counts) - counts).to(device),
            num_samples=torch.tensor(n, device=device),
            num_blocks=torch.tensor(0, device=device), num_superblocks=None,
            coarse_complete=torch.ones(R, dtype=torch.bool, device=device))
        sig = t["sigma"].requires_grad_()
        col = t["rgb"].requires_grad_()
        c, op, dep, _ = renderer.composite(sig, col, samples, R, rc)
        w = t["w"]
        ((c * w[:, :3]).sum() + (op * w[:, 3]).sum()
         + (dep * w[:, 4]).sum()).backward()
        return ([x.detach().cpu() for x in (c, op, dep)],
                [sig.grad.cpu(), col.grad.cpu()])

    out_c, grads_c = run(torch.device("cpu"))
    out_g, grads_g = run(cuda)
    out_g2, grads_g2 = run(cuda)
    for a, b in zip(out_g + grads_g, out_g2 + grads_g2):
        assert torch.equal(a, b)
    for a, b in zip(out_g, out_c):
        assert float((a - b).abs().max()) <= 1e-5
    for a, b in zip(grads_g, grads_c):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_vanilla_field_on_card_matches_cpu(cuda):
    """VanillaNeRFField (weight norm, skip layers) on the card against the
    CPU: outputs and gradients within 1e-4 of their largest entry (float32
    matmuls; the card's may not take TF32: the config's precision)."""
    def make(gen):
        return fields.VanillaNeRFField(
            aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
            contraction_type=contraction.ContractionType.AABB,
            radiance_dim=3, net_depth=8, net_width=64, skip_layer=4,
            net_width_condition=32, weight_norm=True, generator=gen)

    cpu_field, card_field = _card_and_cpu(make, cuda)
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((4096, 3), generator=gen) * 3.2 - 1.6
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=gen),
                                      dim=-1)
    outs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, field, device in (("cpu", cpu_field, torch.device("cpu")),
                                    ("card", card_field, cuda)):
            rgb, sigma = field(x.to(device), d.to(device))
            (rgb.sum() + sigma.sum()).backward()
            outs[name] = [t.detach().double().cpu() for t in (rgb, sigma)] \
                + [p.grad.detach().double().cpu() for p in field.parameters()]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(outs["cpu"], outs["card"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


PB_GRID = [(calib, S, 5, n_clamped, n_out, chip_smoke.PB_FORWARD_ATOL)
           for calib in ("default", "stiff") for S in (4, 12)
           for n_clamped in (0, 5, 11) for n_out in (1, 2)]


@pytest.mark.parametrize("calib,S,M,n_clamped,n_out,fwd_atol", PB_GRID + [
    (*c, 2, chip_smoke.PB_STEP_FORWARD_ATOL) for c in chip_smoke.PB_CASES])
def test_pb_weight_kernels_match_the_plain_chain(cuda, calib, S, M,
                                                 n_clamped, n_out, fwd_atol):
    """Both weight-chain kernels (through `pb_weight.weight`) against
    autograd of the plain chain on the card: on the CPU tests' grid of
    calibrations, window lengths, clamped steps and outputs on 5 events,
    the weights within 5e-5 of the float32 plain chain's largest, NaN
    nowhere it is finite, the cotangents at the CPU tests' tolerances
    (`pb_weight_check`); at the flagship step's shape (S = 30, M = 1,716)
    with chip_smoke.PB_CASES's clamping, the step-scale rule
    (`pb_accuracy_check`: each column no farther from the float64 chain
    than 1.25 times the float32 plain chain's plus PB_STEP_FORWARD_ATOL
    forward and one tolerance backward; ROADMAP C13) and, as phase 3
    holds them, the float32 plain chain's tolerances as well; two runs
    bit for bit."""
    case = chip_smoke.pb_weight_inputs(torch, calib, S, M, n_clamped, n_out,
                                       seed=4)
    if M == chip_smoke.PB_STEP_SHAPE[1]:
        c = chip_smoke.pb_accuracy_check(torch, case, fwd_atol,
                                         float32_gate=True)
    else:
        c = chip_smoke.pb_weight_check(torch, case, fwd_atol)
    assert c["ok"], c


@pytest.mark.parametrize("calib,div", chip_smoke.PB_CONDITIONING_CASES)
def test_pb_weight_kernels_hold_the_step_scale_rule_ill_conditioned(
        cuda, calib, div):
    """The step-scale rule (`pb_accuracy_check`) on chip_smoke's three
    conditioning cases of 32,768 columns, where the float32 chain is far
    from float64 and the kernels miss the float32 plain chain's
    tolerances."""
    case = chip_smoke.pb_conditioning_case(torch, calib, div)
    c = chip_smoke.pb_accuracy_check(torch, case)
    assert c["ok"], chip_smoke.pb_accuracy_text(c)


@pytest.mark.parametrize("plant", list(PLANTS))
def test_pb_accuracy_check_on_a_planted_kernel_error(cuda, monkeypatch,
                                                     plant):
    """`pb_accuracy_check` on the kernels with one entry planted off the
    float64 chain at the flagship step's shape: beyond its column's limit
    in the column where the float32 plain chain is farthest from float64
    or in a well-conditioned one, or a NaN where the plain chain is
    finite, fails it; half a slack within the limit passes."""
    case = chip_smoke.pb_weight_inputs(torch, "default",
                                       *chip_smoke.PB_STEP_SHAPE, 0, 2)
    references = chip_smoke.pb_plain_references(torch, case)
    what, column, size = PLANTS[plant]
    _, _, e_plain, _ = planted_entry(references, what, column, size)
    if column == "best":
        assert chip_smoke.PB_STEP_FACTOR * e_plain <= (
            chip_smoke.PB_STEP_FORWARD_ATOL if what == "forward"
            else chip_smoke.PB_STEP_BACKWARD_SLACK)
    monkeypatch.setattr(pb_weight, "weight", planted_weight(
        references, what, column, size))
    c = chip_smoke.pb_accuracy_check(torch, case, references=references)
    if size < 0:
        assert c["ok"], chip_smoke.pb_accuracy_text(c)
    else:
        assert not c["ok"], chip_smoke.pb_accuracy_text(c)
        assert not c[f"{'fwd' if what == 'forward' else 'bwd'}_ok"]


@pytest.mark.parametrize("plant", ["one weight", "every weight"])
def test_pb_weight_check_fails_on_a_planted_nan_weight(cuda, monkeypatch,
                                                       plant):
    """`pb_weight_check` refuses a forward kernel that writes NaN where the
    plain chain is finite: one planted NaN weight, or all of them."""
    real = pb_weight.weight

    def planted(params, intensity, dt, n_out):
        w = real(params, intensity, dt, n_out).clone()
        if plant == "one weight":
            w[3, 2, 0] = float("nan")
        else:
            w = w * float("nan")
        return w

    monkeypatch.setattr(pb_weight, "weight", planted)
    case = chip_smoke.pb_weight_inputs(torch, "default", 12, 5, 0, 2, seed=4)
    c = chip_smoke.pb_weight_check(torch, case)
    assert not c["fwd_ok"] and not c["ok"], c


def test_pb_weight_step_makes_no_host_sync(cuda):
    """`weight` forward and backward read nothing on the host: no sync
    under torch.cuda.set_sync_debug_mode("error")."""
    case = chip_smoke.pb_weight_inputs(torch, "default", 30, 1716, 3, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chip_smoke.pb_weight_run(torch, pb_weight.weight, case)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_pb_weight_nan_reaches_weights_and_gradients(cuda):
    """A NaN intensity or step: every weight and cotangent the plain chain
    makes NaN, the kernels make NaN too."""
    case = chip_smoke.pb_weight_inputs(torch, "default", 12, 5, 0, 2, seed=4)
    case["intensity"][4, 1] = float("nan")
    case["dt"][7, 3] = float("nan")
    w_k, g_k = chip_smoke.pb_weight_run(torch, pb_weight.weight, case)
    w_p, g_p = chip_smoke.pb_weight_run(torch, pb_weight.weight_reference,
                                        case)
    assert bool(torch.isnan(w_p).any())
    for a, b in zip([w_k, *g_k], [w_p, *g_p]):
        assert bool(torch.isnan(a)[torch.isnan(b)].all())


def test_pb_weight_dispatch_on_the_card(cuda, monkeypatch):
    """On CUDA tensors the model's intensity_sample_to_weight launches one
    forward and one backward kernel and never runs the plain chain."""
    from deblur_e_nerf_tpu_torch.models import pixel_bandwidth

    def no_plain(*args):
        raise AssertionError("the plain chain ran on the card")

    monkeypatch.setattr(pb_weight, "weight_reference", no_plain)
    cal, min_ts, f_c = chip_smoke.PB_CALIBRATIONS["stiff"]
    raw, consts = pixel_bandwidth.init_pixel_bandwidth(cal, min_ts, f_c, 0.95,
                                                       device=cuda)
    case = chip_smoke.pb_weight_inputs(torch, "stiff", 30, 40, 5, 2)
    it = case["intensity"].requires_grad_()
    before = (pb_weight.FORWARD_LAUNCHES, pb_weight.BACKWARD_LAUNCHES)
    w = pixel_bandwidth.intensity_sample_to_weight(
        raw, consts, it, case["dt"], output_sf_log_it=True)
    (w * case["g"]).sum().backward()
    torch.cuda.synchronize()
    assert (pb_weight.FORWARD_LAUNCHES - before[0],
            pb_weight.BACKWARD_LAUNCHES - before[1]) == (1, 1)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in raw.values())
    assert bool(torch.isfinite(it.grad).all())


@pytest.mark.parametrize("calib", ["default", "stiff"])
def test_pb_weight_skips_zero_cotangent_columns_exactly(cuda, calib):
    """Half the columns with a zero cotangent (as the padded batch's
    invalid events have): the backward kernel gives them exactly what
    autograd of the plain chain gives, 0 (as values: a skipped zero is +0
    where autograd may give -0), and the live columns and the parameters
    the cotangents within the CPU tests' tolerances; the finiteness byte
    is the plain model's."""
    case = chip_smoke.pb_weight_inputs(torch, calib, 30, 64, 5, 2, seed=4)
    case["g"][:, ::2] = 0.0
    w_k, g_k = chip_smoke.pb_weight_run(torch, pb_weight.weight, case)
    w_p, g_p = chip_smoke.pb_weight_run(torch, pb_weight.weight_reference,
                                        case)
    for a, b in zip(g_k[:2], g_p[:2]):
        assert bool((a[:, ::2] == 0).all() and (b[:, ::2] == 0).all())
    ratios, _ = chip_smoke.pb_weight_errors(
        torch, [g_k[0][:, 1::2], g_k[1][:, 1::2], g_k[2]],
        [g_p[0][:, 1::2], g_p[1][:, 1::2], g_p[2]])
    assert all(r <= 1 for r in ratios.values()), ratios
    args = [case[k] for k in ("params", "intensity", "dt")]
    _, finite, _ = pb_weight.weight_forward(*args, 2)
    assert torch.equal(finite, pb_weight.weight_forward_model(*args, 2)[1])
    assert bool(finite.all())


def test_pb_weight_nan_in_a_zero_cotangent_column(cuda):
    """A column whose cotangent is zero but whose intensity holds a NaN:
    its finiteness byte is unset, so the backward kernel reverses it and
    gives NaN wherever autograd of the plain chain does (0 * NaN), the
    parameters' cotangents included."""
    case = chip_smoke.pb_weight_inputs(torch, "default", 12, 5, 0, 2, seed=4)
    case["g"][:, 1] = 0.0
    case["g"][:, 3] = 0.0
    case["intensity"][4, 1] = float("nan")
    args = [case[k] for k in ("params", "intensity", "dt")]
    _, finite, _ = pb_weight.weight_forward(*args, 2)
    assert finite.tolist() == [True, False, True, True, True]
    _, g_k = chip_smoke.pb_weight_run(torch, pb_weight.weight, case)
    _, g_p = chip_smoke.pb_weight_run(torch, pb_weight.weight_reference,
                                      case)
    assert bool(torch.isnan(g_p[0][:, 1]).any())
    assert bool(torch.isnan(g_p[2]).all())
    for a, b in zip(g_k, g_p):
        assert bool(torch.isnan(a)[torch.isnan(b)].all())
    assert bool((g_k[0][:, 3] == 0).all() and (g_k[1][:, 3] == 0).all())


def test_pb_weight_kernels_keep_no_local_memory(cuda):
    """Neither weight-chain kernel, as loaded, has a local-memory stack
    frame or spills (the backward once kept its squarings' inputs
    there)."""
    attrs = pb_weight.kernel_attributes()
    assert set(attrs) == {"pb_weight_fwd_kernel", "pb_weight_bwd_kernel"}
    for name, (registers, local_bytes) in attrs.items():
        assert 0 < registers <= 255, name
        assert local_bytes == 0, (name, local_bytes)


def test_pb_weight_wrappers_raise_instead_of_falling_back(cuda):
    case = chip_smoke.pb_weight_inputs(torch, "default", 12, 5, 0, 2)
    p, it, dt, g = (case[k] for k in ("params", "intensity", "dt", "g"))
    finite = torch.ones(it.shape[1:], dtype=torch.bool, device=cuda)
    systems = torch.zeros(5, 11, 16, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        pb_weight.weight_forward(p, it.double(), dt, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pb_weight.weight_backward(p, it, dt, g.transpose(0, 1).contiguous()
                                  .transpose(0, 1), 2, finite, systems)
    with pytest.raises(ValueError, match="finite must be bool"):
        pb_weight.weight_backward(p, it, dt, g, 2, finite.float(), systems)
    with pytest.raises(ValueError, match="saved systems"):
        pb_weight.weight_backward(p, it, dt, g, 2, finite, None)
    with pytest.raises(ValueError, match="systems"):
        pb_weight.weight_backward(p, it, dt, g, 2, finite,
                                  torch.zeros(5, 11, 23, device=cuda))
    long = chip_smoke.pb_weight_inputs(torch, "default", 34, 5, 0, 2)
    with pytest.raises(ValueError, match="at most 32 systems"):
        pb_weight.weight_forward(long["params"], long["intensity"],
                                 long["dt"], 2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        pb_weight.weight_forward(p.cpu(), it, dt, 2)


# the render layer's scans: the compaction and the composite kernels


@pytest.mark.parametrize("n,fraction,budget_of,cutoff,prepass", [
    (1, 1.0, 1.0, True, False),           # one lane
    (4097, 0.5, 2.0, True, False),        # two tiles, below the budget
    (1000003, 0.3, 2.0, True, False),     # ragged tiles, below
    (1000003, 0.6, 0.5, True, False),     # overflow, with the cutoff
    (1000003, 0.5, 1.0, False, False),    # at the budget
    (1000003, 0.0, None, True, False),    # nothing flagged
    (1000003, 1.0, 0.25, True, False),    # every lane, overflow
    (1228801, 0.4, 0.5, False, True),     # the prepass's three channels
    (1228801, 0.4, 2.0, False, True),
])
def test_compact_kernel_matches_plain_bit_for_bit(cuda, n, fraction,
                                                  budget_of, cutoff,
                                                  prepass):
    """Every buffer, the total and the cutoff bit for bit against the plain
    version, and two runs bit for bit (chip_smoke.compact_case)."""
    flags, payloads, fills = chip_smoke.compact_inputs(torch, n, fraction,
                                                       prepass, seed=n % 7)
    total = int(flags.sum())
    budget = int(total * budget_of) if budget_of is not None else 1000
    before = compact.LAUNCHES
    row = chip_smoke.compact_case(torch, "card test", "synthetic", flags,
                                  payloads, budget, fills, cutoff)
    assert row["bit_exact"] and row["reproducible"]
    assert compact.LAUNCHES > before


def _tile_edges():
    """(n, fraction, budget, cutoff, offset) at each of the kernel's tile
    sizes (compact.TILES, each chosen for a range of lane counts): one
    short of, equal to and one past a multiple of the tile, the first
    such multiple in its range; two tiles and a ragged third with the
    flags 3 bytes into their tensor; and the same with every lane
    flagged, 1 byte in."""
    cases, below = [], 0
    for tile, most in compact.TILES:
        m = below // tile + 1
        cases += [(m * tile + d, 0.5, None, True, 0) for d in (-1, 0, 1)]
        cases += [((m + 1) * tile + 1, 0.5, None, True, 3),
                  (m * tile + 1, 1.0, None, False, 1)]
        below = most
    return cases


@pytest.mark.parametrize("n,fraction,budget,cutoff,offset", [
    (1, 1.0, 0, True, 0),                     # one lane, dropped
    (1, 0.0, 3, True, 0),                     # one lane, not flagged
    *_tile_edges(),
    (100003, 0.0, 50, True, 0),               # no lane flagged
    (100003, 1.0, 200000, True, 0),           # every lane, below the budget
    (100003, 1.0, 100003, False, 0),          # every lane, at the budget
    (100003, 0.7, 0, True, 0),                # budget 0
    (100003, 1.0, 0, True, 0),                # budget 0, every lane dropped
    (100003, 0.6, 1000, True, 0),             # an overflow with the cutoff
    (100003, 0.6, 1000, False, 0),            # an overflow without it
])
def test_compact_edge_cases_bit_for_bit(cuda, n, fraction, budget, cutoff,
                                        offset):
    """The single-pass compaction at the edges of its tiles
    (`_tile_edges`), flags and budget: every buffer, the total and the
    cutoff bit for bit against the plain version, two runs bit for bit
    (chip_smoke.compact_case); a budget of None is half the flagged lanes.
    With an offset the flags and payloads are slices starting that many
    lanes into their tensors, so the flags are read byte by byte."""
    flags, payloads, fills = chip_smoke.compact_inputs(
        torch, n + offset, fraction, False, seed=n % 5)
    flags, payloads = flags[offset:], [p[offset:] for p in payloads]
    assert (flags.data_ptr() % 16 != 0) == (offset != 0)
    if budget is None:
        budget = int(flags.sum()) // 2
    row = chip_smoke.compact_case(torch, "card test", "edge", flags,
                                  payloads, budget, fills, cutoff)
    assert row["bit_exact"] and row["reproducible"]


def test_compact_many_tiles_and_repeated_runs(cuda):
    """More than 2^16 tiles (the look-back crosses many waves of blocks),
    an overflow with the cutoff and a float32 second channel: bit for bit
    against the plain version, and 20 runs with the same bits."""
    n = (1 << 16) * compact.TILE + 4097
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    flags = torch.rand(n, generator=gen, device=cuda) < 0.05
    codes = torch.arange(n, dtype=torch.int64, device=cuda) * 5 + 1
    values = torch.rand(n, generator=gen, device=cuda)
    total = int(flags.sum())
    budget = total - total // 10
    args = (flags, [codes, values], budget, [5 * n + 1, -1.0], True)
    row = chip_smoke.compact_case(torch, "card test", "2^16 tiles", *args)
    assert row["bit_exact"] and row["reproducible"]
    first = compact.compact(*args)
    for _ in range(20):
        again = compact.compact(*args)
        assert all(torch.equal(chip_smoke._bits(torch, a),
                               chip_smoke._bits(torch, b))
                   for a, b in zip(first[0], again[0]))
        assert int(again[1]) == int(first[1]) == total
        assert int(again[2]) == int(first[2])


def test_compact_wrapper_raises_instead_of_falling_back(cuda):
    flags = torch.ones(10, dtype=torch.bool, device=cuda)
    codes = torch.arange(10, device=cuda)
    with pytest.raises(TypeError, match="bool"):
        compact.compact(flags.int(), [codes], 5, [0])
    with pytest.raises(TypeError, match="int64"):
        compact.compact(flags, [codes.float()], 5, [0], True)
    with pytest.raises(ValueError, match="contiguous"):
        compact.compact(flags, [torch.arange(20, device=cuda)[::2]], 5, [0])
    with pytest.raises(ValueError, match="payloads"):
        compact.compact(flags, [codes] * 4, 5, [0] * 4)
    with pytest.raises(ValueError, match="flags on"):
        compact.compact(flags, [codes.cpu()], 5, [0])


def _zero_count_rays(case):
    """Give every fifth ray of a composite case no samples (its slots go
    to the next rays)."""
    counts = case["counts"].clone()
    counts[::5] = 0
    n, n_rays = case["dt"].shape[0], case["n_rays"]
    filled = min(int(counts.sum()), n - 1)
    ray_idx = torch.full_like(case["ray_idx"], n_rays)
    ray_idx[:filled] = torch.repeat_interleave(
        torch.arange(n_rays, device=counts.device), counts)[:filled]
    valid = ray_idx < n_rays
    # an empty slot's sigma stays finite, as a field's is there (an
    # infinite one would make the plain version's sigma dt 0 x inf = NaN)
    return dict(case, counts=counts, ray_idx=ray_idx,
                offsets=torch.cumsum(counts, 0) - counts,
                dt=torch.where(valid, case["dt"].clamp(min=0.005), 0.0),
                sigma=torch.where(valid, case["sigma"], 1.0))


@pytest.mark.parametrize("alpha_thre", [0.0, 0.05])
@pytest.mark.parametrize("channels,dtype,kind", [
    (3, torch.float32, "dense"), (1, torch.float32, "dense"),
    (3, torch.float64, "dense"), (3, torch.float32, "zero-count rays")])
def test_composite_kernels_match_plain(cuda, alpha_thre, channels, dtype,
                                       kind):
    """Forward (colours, opacities, depths; live counts and the prepass's
    density-only mask exactly), backward (sigma and rgb cotangents) within
    chip_smoke's COMPOSITE_* tolerances of the plain version through
    autograd, every output of two runs bit for bit
    (chip_smoke.composite_case), on 200,001 slots of 700 rays with early
    stop, clamped and truncated rays; in float64 too (the prepass check's
    render), and with rays of no samples."""
    case = chip_smoke.composite_inputs(torch, 200001, 700, channels,
                                       density=6.0, seed=channels)
    if kind == "zero-count rays":
        case = _zero_count_rays(case)
    case["sigma"], case["rgb"] = (case["sigma"].to(dtype),
                                  case["rgb"].to(dtype))
    cot = tuple(g.to(dtype) for g in chip_smoke.composite_cotangents(
        torch, 700, channels))
    before = (composite.FORWARD_LAUNCHES, composite.BACKWARD_LAUNCHES)
    fwd, bwd = chip_smoke.composite_case(torch, "card test", kind, case,
                                         1e-4, alpha_thre, cot)
    assert fwd["live_equal"] and fwd["reproducible"]
    assert 0 < fwd["live_samples"] < fwd["segment_slots"]
    assert composite.FORWARD_LAUNCHES > before[0]
    assert composite.BACKWARD_LAUNCHES > before[1]


def _edge_counts(kind):
    """(counts, slots, density) of the composite's edge cases."""
    rng = np.random.default_rng(7)
    if kind == "a ray longer than a partition":
        return [3, 100000, 5], 100009, 0.01
    if kind == "one-slot rays":
        return [1] * 50000, 50001, 6.0
    if kind == "95% empty rays at 983,040":
        # 5% of the rays carry 200-400 samples, none in the last tenth
        n_rays = 983040
        counts = np.zeros(n_rays, np.int64)
        hit = rng.choice(n_rays * 9 // 10, n_rays // 20, replace=False)
        counts[hit] = rng.integers(200, 401, hit.size)
        return counts, int(counts.sum()) + 1, 6.0
    if kind == "early stop in a ray's first slots":
        return rng.integers(50, 151, 2000), 200001, 3000.0
    raise ValueError(kind)


@pytest.mark.parametrize("kind,alpha_thre,dtype", [
    ("a ray longer than a partition", 0.0, torch.float32),
    ("a ray longer than a partition", 0.05, torch.float64),
    ("one-slot rays", 0.0, torch.float32),
    ("95% empty rays at 983,040", 0.0, torch.float32),
    ("95% empty rays at 983,040", 0.05, torch.float32),
    ("95% empty rays at 983,040", 0.0, torch.float64),
    ("early stop in a ray's first slots", 0.0, torch.float32),
    ("early stop in a ray's first slots", 0.05, torch.float64),
])
def test_composite_edge_cases(cuda, kind, alpha_thre, dtype):
    """The partitioned forward where its partitions, rays and early stop
    meet: held to the plain version as in every case
    (chip_smoke.composite_case: outputs within COMPOSITE_FWD_*, live
    counts and the density-only mask equal, the backward reading the new
    T within COMPOSITE_BWD_*, two runs bit for bit), with inf and 1e5
    sigmas in every buffer."""
    counts, n_slots, density = _edge_counts(kind)
    counts = torch.as_tensor(np.asarray(counts), dtype=torch.int64,
                             device=cuda)
    n_rays = counts.numel()
    case = chip_smoke.composite_inputs(torch, n_slots, n_rays, 3, density,
                                       seed=5, counts=counts)
    case["sigma"], case["rgb"] = (case["sigma"].to(dtype),
                                  case["rgb"].to(dtype))
    cot = tuple(g.to(dtype) for g in chip_smoke.composite_cotangents(
        torch, n_rays, 3))
    fwd, _ = chip_smoke.composite_case(torch, "card test", kind, case, 1e-4,
                                       alpha_thre, cot)
    assert fwd["live_equal"] and fwd["reproducible"]
    assert 0 < fwd["live_samples"] <= fwd["segment_slots"]


def test_composite_forward_twenty_runs_bit_for_bit(cuda):
    """The forward's every output (colours, opacities, depths, live
    counts, T of the segments' slots) and the density-only call's mask
    and counts: 20 runs with the same bits, on the 95%-empty batch and on
    a ray longer than a partition."""
    for kind in ("95% empty rays at 983,040",
                 "a ray longer than a partition"):
        counts, n_slots, density = _edge_counts(kind)
        counts = torch.as_tensor(np.asarray(counts), dtype=torch.int64,
                                 device=cuda)
        c = chip_smoke.composite_inputs(torch, n_slots, counts.numel(), 3,
                                        density, seed=9, counts=counts)
        args = (c["sigma"], c["rgb"], c["t_mid"], c["dt"], c["ray_idx"],
                c["offsets"], c["counts"], c["n_rays"], 1e-4, 0.0)
        segment = min(int(c["offsets"][-1] + c["counts"][-1]), n_slots)

        def outputs():
            out = composite.composite_forward(*args, save_trans=True)
            live = composite.live_mask(c["sigma"], *args[3:])
            return [chip_smoke._bits(torch, t) for t in
                    (*out[:4], out[4][:segment], *live)]

        first = outputs()
        for _ in range(20):
            assert all(torch.equal(a, b) for a, b in zip(first, outputs()))


def _poison_allocator(device, *nbytes):
    """Free blocks of these byte sizes, filled with 0xAB, so that the next
    torch.empty of each size likely returns them: an output that a kernel
    leaves unwritten then reads as garbage, not as zeros."""
    blocks = [torch.full((b,), 0xAB, dtype=torch.uint8, device=device)
              for b in nbytes]
    torch.cuda.synchronize()
    del blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("counts,n_slots", [
    ([3] * 1000 + [5, 4, 0, 2], 3001),  # ray 1000 starts at the last slot
    ([4, 0, 2], 1),                     # a budget of 0: one empty slot
], ids=["a ray starting at the last slot", "budget 0"])
def test_composite_ray_starting_at_the_empty_last_slot(cuda, counts,
                                                       n_slots, dtype):
    """The march's counts are demands, so a ray may start at the buffer's
    last slot, which is always empty: it has no sample in the buffer, and
    its colours, opacity, depth and live count are zeros, as the plain
    version's; every slot's live flag is the plain version's. The outputs'
    memory is poisoned first, so an unwritten output shows. Then the
    whole buffer as every case (chip_smoke.composite_case)."""
    counts = torch.tensor(counts, dtype=torch.int64, device=cuda)
    n_rays = counts.numel()
    case = chip_smoke.composite_inputs(torch, n_slots, n_rays, 3, 6.0,
                                       seed=3, counts=counts)
    case["sigma"], case["rgb"] = (case["sigma"].to(dtype),
                                  case["rgb"].to(dtype))
    starts = torch.nonzero((case["offsets"] == n_slots - 1)
                           & (counts > 0)).flatten()
    assert starts.numel() == 1
    r = int(starts[0])
    args = (case["sigma"], case["rgb"], case["t_mid"], case["dt"],
            case["ray_idx"], case["offsets"], counts, n_rays, 1e-4, 0.0)
    width = case["sigma"].element_size()
    _poison_allocator(cuda, n_rays * 3 * width, n_rays * width,
                      n_rays * width, n_rays * 8, n_slots * width)
    got = composite.composite_forward(*args, save_trans=True)
    _poison_allocator(cuda, n_rays * 8, n_slots)
    live = composite.live_mask(case["sigma"], *args[3:])
    with torch.no_grad():
        plain = composite.composite_reference(*args)
    plain_live = composite.live_mask_reference(case["sigma"], *args[3:])
    assert float(got[0][r].abs().sum()) == 0.0
    assert float(got[1][r]) == 0.0 and float(got[2][r]) == 0.0
    assert int(got[3][r]) == 0 and int(live[1][r]) == 0
    assert not bool(live[0][n_slots - 1])
    assert torch.isfinite(got[4]).all()
    assert torch.equal(got[3], plain[3])
    assert torch.equal(live[0], plain_live[0])
    assert torch.equal(live[1], plain_live[1])
    for a, b in zip(got[:3], plain[:3]):
        torch.testing.assert_close(a, b, rtol=chip_smoke.COMPOSITE_FWD_RTOL,
                                   atol=chip_smoke.COMPOSITE_FWD_ATOL,
                                   equal_nan=True)
    cot = tuple(g.to(dtype) for g in chip_smoke.composite_cotangents(
        torch, n_rays, 3))
    fwd, _ = chip_smoke.composite_case(torch, "card test", "last slot",
                                       case, 1e-4, 0.0, cot)
    assert fwd["live_equal"] and fwd["reproducible"]


def test_composite_on_a_march_whose_demand_overflows_its_budget(cuda):
    """A march cut to a sample budget equal to one ray's demand offset: that
    ray starts at the buffer's last (empty) slot and the rays after it lie
    past the buffer. The composite and the density-only call on that
    buffer, held to the plain version as every case
    (chip_smoke.composite_case)."""
    import dataclasses

    from deblur_e_nerf_tpu_torch.models import renderer

    rc = chip_smoke.march_render_config(chip_smoke.MARCH_CONFIGS[0][1])
    n_rays = 4096
    inputs = chip_smoke.march_inputs(torch, rc, n_rays, 0.3, 0.05)
    full = renderer.march_rays(*inputs, rc)
    hit = torch.nonzero((full.counts > 0) & (full.offsets > 0)).flatten()
    assert hit.numel() > 2
    r = int(hit[hit.numel() // 2])
    budget = int(full.offsets[r])
    cut = dataclasses.replace(rc, sample_budget=budget,
                              block_budget=rc.block_capacity)
    samples = renderer.march_rays(*inputs, cut)
    n = samples.t_mid.shape[0]
    assert n == budget + 1 and int(samples.num_samples) > budget
    assert int(samples.offsets[r]) == n - 1 and int(samples.counts[r]) > 0
    assert int(samples.ray_idx[n - 1]) == n_rays
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    case = {"sigma": torch.rand(n, generator=gen, device=cuda) * 6.0,
            "rgb": torch.rand((n, 3), generator=gen, device=cuda),
            "t_mid": samples.t_mid, "dt": samples.dt,
            "ray_idx": samples.ray_idx, "offsets": samples.offsets,
            "counts": samples.counts, "n_rays": n_rays}
    fwd, _ = chip_smoke.composite_case(
        torch, "card test", "march overflow", case, rc.early_stop_eps,
        rc.alpha_thre, chip_smoke.composite_cotangents(torch, n_rays, 3))
    assert fwd["live_equal"] and fwd["reproducible"]
    assert 0 < fwd["live_samples"] <= n - 1


def test_composite_through_the_renderer_launches_the_kernels(cuda):
    """renderer.composite on card tensors goes through the kernels (one
    forward, one backward) and its num_rendering_samples is the live
    counts' sum."""
    from deblur_e_nerf_tpu_torch.models import renderer

    case = chip_smoke.composite_inputs(torch, 50001, 200, 3, density=6.0)
    samples = renderer.RaySamples(
        t_mid=case["t_mid"], dt=case["dt"], ray_idx=case["ray_idx"],
        counts=case["counts"], offsets=case["offsets"],
        num_samples=case["counts"].sum(), num_blocks=torch.tensor(0),
        num_superblocks=None,
        coarse_complete=torch.ones(200, dtype=torch.bool, device=cuda))
    rc = renderer.RenderConfig(
        aabb=(-1.0,) * 3 + (1.0,) * 3,
        contraction_type=contraction.ContractionType.AABB,
        grid_resolution=16, near_plane=0.0, far_plane=None,
        render_step_size=0.01)
    sig = case["sigma"].requires_grad_()
    col = case["rgb"].requires_grad_()
    before = (composite.FORWARD_LAUNCHES, composite.BACKWARD_LAUNCHES)
    c, op, dep, n_live = renderer.composite(sig, col, samples, 200, rc)
    (c.sum() + op.sum() + dep.sum()).backward()
    torch.cuda.synchronize()
    assert (composite.FORWARD_LAUNCHES - before[0],
            composite.BACKWARD_LAUNCHES - before[1]) == (1, 1)
    plain = composite.composite_reference(
        case["sigma"].detach(), case["rgb"].detach(), case["t_mid"],
        case["dt"], case["ray_idx"], case["offsets"], case["counts"], 200,
        rc.early_stop_eps, rc.alpha_thre)
    assert int(n_live) == int(plain[3].sum())


def test_composite_wrapper_raises_instead_of_falling_back(cuda):
    case = chip_smoke.composite_inputs(torch, 1001, 10, 3, density=6.0)
    args = [case[k] for k in ("sigma", "rgb", "t_mid", "dt", "ray_idx",
                              "offsets", "counts")] + [10, 1e-4, 0.0]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        composite.composite_forward(*[a.cpu() if torch.is_tensor(a) else a
                                      for a in args])
    with pytest.raises(TypeError, match="float32 or float64"):
        composite.composite_forward(args[0].half(), *args[1:])
    with pytest.raises(TypeError, match="rgb is"):
        composite.composite_forward(args[0], args[1].double(), *args[2:])
    with pytest.raises(TypeError, match="int64"):
        composite.composite_forward(*args[:4], args[4].int(), *args[5:])
    with pytest.raises(ValueError, match="contiguous"):
        composite.composite_forward(
            *args[:3], torch.stack([args[3], args[3]], 1)[:, 0], *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        composite.composite_forward(
            torch.stack([args[0], args[0]], 1)[:, 0], *args[1:])
    with pytest.raises(ValueError, match="offsets and counts"):
        composite.composite_forward(*args[:7], 11, *args[8:])


# the march's stages (csrc/march.cu)

MARCH_SMALL = [(label, path, n_rays // 64)
               for label, path, n_rays in chip_smoke.MARCH_CONFIGS]


@pytest.mark.parametrize("label,path,n_rays", MARCH_SMALL)
def test_march_kernels_match_plain(cuda, label, path, n_rays):
    """Each march kernel on its plain version's inputs, every output bit
    for bit (under EDS's cone angle t_mid and dt within 2 ulp, the sample
    sets equal), two runs bit for bit, its launches a march; march_rays
    against march_reference; at the config's budgets and cut below every
    stage's demand (chip_smoke.march_cases), at 1/64 of a step's rays."""
    rc = chip_smoke.march_render_config(path)
    inputs = chip_smoke.march_inputs(torch, rc, n_rays,
                                     *chip_smoke.MARCH_SCENES[label])
    rows = chip_smoke.march_cases(torch, f"card test {label}", inputs, rc)
    for kernel in chip_smoke.MARCH_KERNELS:
        assert all(r["within_rule"] and r["reproducible"]
                   for r in rows[kernel])
    assert all(r["equal_to_plain"] for r in rows["march"])


def test_march_kernels_match_plain_under_tanh_contraction(cuda):
    """The tanh contraction (no config of the repo uses it) through the
    same checks, on the flagship's geometry."""
    import dataclasses

    from deblur_e_nerf_tpu_torch.models.contraction import ContractionType

    rc = dataclasses.replace(
        chip_smoke.march_render_config(chip_smoke.MARCH_CONFIGS[0][1]),
        contraction_type=ContractionType.UN_BOUNDED_TANH)
    inputs = chip_smoke.march_inputs(torch, rc, 4096, 0.3, 0.2)
    rows = chip_smoke.march_cases(torch, "card test tanh", inputs, rc,
                                  below=False)
    assert all(r["equal_to_plain"] for r in rows["march"])


@pytest.mark.parametrize("label,path,n_rays", MARCH_SMALL)
def test_march_lane_model_on_the_card(cuda, label, path, n_rays):
    """The kernels' model with the card's division (a product with the
    step's float32 reciprocal, as torch's CUDA kernel divides by a Python
    number) equals the plain version on the card output for output, the
    codes where the flags are set (the stages' contract)."""
    from deblur_e_nerf_tpu_torch.ops import march as mo

    rc = chip_smoke.march_render_config(path)
    inputs = chip_smoke.march_inputs(torch, rc, n_rays // 4,
                                     *chip_smoke.MARCH_SCENES[label], seed=1)
    calls, _ = chip_smoke.march_stage_calls(inputs, rc)
    models = {"march_masks": mo.masks_model,
              "march_coarse": mo.coarse_model,
              "march_samples": mo.samples_model,
              "march_decode": mo.decode_model}
    for kernel, stage, args, want in calls:
        extra = {} if kernel == "march_masks" else {"cuda_division": True}
        got = models[kernel](*args, **extra)
        for name, a, b in zip(chip_smoke.MARCH_OUTPUTS[kernel], got, want):
            if name == "codes":
                a, b = a[want[0]], b[want[0]]
            assert (a is None and b is None) or torch.equal(a, b), \
                (kernel, stage, name)


def test_march_through_the_renderer_launches_the_kernels(cuda):
    """march_rays on card tensors launches the masks once, two coarse
    stages, the samples and the decode once each, and three compactions
    (chip_smoke.render_launches' march counts)."""
    from deblur_e_nerf_tpu_torch.models import renderer

    rc = chip_smoke.march_render_config(chip_smoke.MARCH_CONFIGS[0][1])
    inputs = chip_smoke.march_inputs(torch, rc, 4096, 0.3, 0.05)
    chip_smoke.reset_launches()
    renderer.march_rays(*inputs, rc)
    torch.cuda.synchronize()
    got = chip_smoke.read_launches()
    want = chip_smoke.render_launches(rc, trains=False)
    assert {k: got[k] for k in chip_smoke.MARCH_KERNELS + ("compact",)} \
        == {k: want[k] for k in chip_smoke.MARCH_KERNELS + ("compact",)}


# (side, superblocks): the flagship's 128^3 with superblocks, EDS's 256^3
# (and with superblocks), r5fix's 64^3 (and with), a side a multiple of 4
# but not of 16 (32-bit chunks), one not a multiple of 4 (bytes, no pool)
MASK_SIZES = [(128, True), (256, False), (256, True), (64, False),
              (64, True), (36, True), (36, False), (50, False)]


@pytest.mark.parametrize("fill", ["random", "full", "empty"])
@pytest.mark.parametrize("res,superblocks", MASK_SIZES)
def test_masks_kernel_matches_plain(cuda, res, superblocks, fill):
    """The masks kernel (one launch) against masks_reference bit for bit,
    dilated and pooled, on a random grid occupied in a ball (the pooled
    mask neither empty nor full), a full and an empty one; two runs bit
    for bit."""
    from deblur_e_nerf_tpu_torch.ops import march as mo

    rc = _march_rc(grid_resolution=res)
    if fill == "random":
        binary = chip_smoke.march_inputs(torch, rc, 8, 0.3, 0.2)[0]
    else:
        binary = torch.full((res ** 3,), fill == "full", device=cuda)
    before = mo.MASKS_LAUNCHES
    got = mo.masks(binary, rc, superblocks)
    again = mo.masks(binary, rc, superblocks)
    torch.cuda.synchronize()
    assert mo.MASKS_LAUNCHES == before + 2
    want = mo.masks_reference(binary, rc, superblocks)
    for a, b, c in zip(got, want, again):
        assert (a is None and b is None and c is None) or (
            torch.equal(a, b) and torch.equal(c, b))
    if superblocks and fill == "random":
        assert 0 < int(got[1].sum()) < got[1].numel()


def _march_rc(index=0, **changes):
    """A render config of chip_smoke.MARCH_CONFIGS[index] with changes."""
    import dataclasses

    rc = chip_smoke.march_render_config(chip_smoke.MARCH_CONFIGS[index][1])
    return dataclasses.replace(rc, **changes)


def _march_rows_hold(rows, whole):
    """Every march kernel within its rule and reproducible, the coarse and
    sample stages bit for bit, the whole march equal to the plain one."""
    for kernel in chip_smoke.MARCH_KERNELS:
        assert rows[kernel]["within_rule"], kernel
        assert rows[kernel]["reproducible"], kernel
    assert rows["march_coarse"]["bit_exact"]
    assert rows["march_samples"]["bit_exact"]
    assert whole["equal_to_plain"]


@pytest.mark.parametrize("label,index,changes,n_rays", [
    # the step < S edge of the last block, the dense stage
    ("S = 1021, dense", 0, dict(max_samples_per_ray=1021,
                                superblock_budget=0), 3001),
    ("S = 13, dense", 0, dict(max_samples_per_ray=13, superblock_budget=0),
     5001),
    # runs of rays that do not fill the 8,192-lane tile: 256 rays of 5
    # superblocks, 234 rays of 35 superblocks or blocks (8,190 lanes: a
    # run's flags start off a 16-byte boundary); 3001 rays: the last run
    # short
    ("n_superblocks = 5", 0, dict(max_samples_per_ray=160), 3001),
    ("n_superblocks = 35", 0, dict(max_samples_per_ray=1120), 3001),
    ("n_blocks = 35, dense", 0, dict(max_samples_per_ray=280,
                                     superblock_budget=0), 3001),
    # a ray's lanes past one tile: one ray a block, two chunks
    ("n_blocks = 8750, dense", 0, dict(max_samples_per_ray=70000,
                                       superblock_budget=0), 301),
    # EDS's cone angle and sphere contraction at S not a multiple of 8;
    # and past the 2,048 powers a block keeps (the rest by powf)
    ("EDS, S = 1019", 1, dict(max_samples_per_ray=1019), 3001),
    ("EDS, S = 3000", 1, dict(max_samples_per_ray=3000), 1001),
])
def test_march_kernels_at_the_tile_and_step_edges(cuda, label, index,
                                                  changes, n_rays):
    """The coarse and sample kernels (and the masks and decode) against
    their plain versions at the edges of the redesigned kernels' work
    split, every cell occupied so that every stage flags lanes: flags,
    the codes of flagged lanes, the bounds and counts bit for bit, two runs
    bit for bit, march_rays equal to march_reference; and with every
    budget cut below its demand."""
    rc = _march_rc(index, **changes)
    inputs = chip_smoke.march_inputs(torch, rc, n_rays, 1.0, 1.0)
    rows, whole, demand = chip_smoke.march_case(
        torch, f"card test {label}", "edge", inputs, rc, timed=False)
    _march_rows_hold(rows, whole)
    assert min(demand.values()) > 1, demand
    rows, whole, _ = chip_smoke.march_case(
        torch, f"card test {label}", "edge, cut budgets", inputs,
        chip_smoke.cut_budgets(rc, demand), timed=False)
    _march_rows_hold(rows, whole)
    assert all(whole["overflow"].values())


def test_march_sample_counts_over_warps_and_ray_segments(cuda):
    """The sample stage's segmented demand count on a block buffer cut so
    that a warp's 32 slots hold several rays' blocks and a ray's slots run
    over two and three warps: each ray keeps its first 1, 2, 3, 5, 40 or 70
    blocks of the plain block buffer, in turn. Flags, the codes of flagged
    lanes and the counts against the plain version, bit for bit."""
    from deblur_e_nerf_tpu_torch.ops import march as mo

    rc = _march_rc()
    inputs = chip_smoke.march_inputs(torch, rc, 2048, 1.0, 1.0)
    calls, _ = chip_smoke.march_stage_calls(inputs, rc)
    (o, d, binary, t_near, t_far, blk_buf, _), _ = [
        (c[2], c[3]) for c in calls if c[0] == "march_samples"][0]
    R, n_blocks = o.shape[0], mo.n_blocks_of(rc)
    live = blk_buf[blk_buf < R * n_blocks]
    ray = live // n_blocks
    first = torch.searchsorted(ray, ray, right=False)
    keep_n = torch.tensor([1, 2, 3, 5, 40, 70], device=cuda)[ray % 6]
    kept = live[(torch.arange(live.numel(), device=cuda) - first) < keep_n]
    buf = torch.cat([kept, kept.new_full((1,), R * n_blocks)])
    kept_ray = (kept // n_blocks).cpu()
    runs = torch.unique_consecutive(kept_ray, return_counts=True)[1]
    assert int(runs.max()) > 64  # a ray over three warps
    warp_rays = [len(set(kept_ray[i:i + 32].tolist()))
                 for i in range(0, kept_ray.numel(), 32)]
    assert max(warp_rays) >= 5  # a warp of several rays
    got = mo.samples(o, d, binary, t_near, t_far, buf, rc)
    want = mo.samples_reference(o, d, binary, t_near, t_far, buf, rc)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1][want[0]], want[1][want[0]])
    assert torch.equal(got[2], want[2]) and int(want[2].sum()) > 0


def _carved_bytes(*nbytes):
    """The bytes of ops._cuda_build.carve's one allocation of these sizes."""
    return sum(-(-b // 16) * 16 for b in nbytes)


POISON = int.from_bytes(b"\xab" * 8, "little", signed=True)


@pytest.mark.parametrize("index", [0, 1])
def test_march_stage_outputs_poisoned_before_the_call(cuda, index):
    """The coarse and sample stages' output memory filled with 0xAB before
    each call: their flags and the codes of flagged lanes equal the plain
    version's, the unflagged lanes' codes are left as the memory held them
    (the poison shows there: no kernel writes them), and the compaction of
    the poisoned outputs equals the plain compaction of the plain outputs
    at the stage's budget and at half its flagged lanes (the cutoff reads
    dropped flagged lanes only); then the whole march with every stage's
    memory poisoned equals march_reference (flagship: superblocks; EDS:
    the dense stage with a cone angle)."""
    from deblur_e_nerf_tpu_torch.models import renderer
    from deblur_e_nerf_tpu_torch.ops import march as mo

    rc = _march_rc(index)
    inputs = chip_smoke.march_inputs(torch, rc, 4096,
                                     *chip_smoke.MARCH_SCENES[
                                         chip_smoke.MARCH_CONFIGS[index][0]])
    R = inputs[1].shape[0]
    calls, _ = chip_smoke.march_stage_calls(inputs, rc)
    sizes = []
    for kernel, stage, args, want in calls:
        if kernel == "march_coarse":
            n = want[0].numel()
            size = (_carved_bytes(8 * n, n) if args[0] == mo.BLOCKS_AFTER
                    else _carved_bytes(8 * n, 4 * R, 4 * R, n))
            fn = mo.coarse
        elif kernel == "march_samples":
            n = want[0].numel()
            size = _carved_bytes(8 * n, n)
            fn = mo.samples
        else:
            continue
        sizes.append(size)
        _poison_allocator(cuda, size)
        got = fn(*args)
        torch.cuda.synchronize()
        flags = want[0]
        assert torch.equal(got[0], flags), stage
        assert torch.equal(got[1][flags], want[1][flags]), stage
        assert bool((got[1][~flags] == POISON).any()), stage
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a, b), stage
        flagged = int(flags.sum())
        fill = [int(want[1].max()) + 1]
        for budget in (max(flagged, 1), max(flagged // 2, 1)):
            a = compact.compact(got[0], [got[1]], budget, fill, True)
            b = compact.compact_reference(flags, [want[1]], budget, fill,
                                          True)
            assert torch.equal(a[0][0], b[0][0]), (stage, budget)
            assert [int(x) for x in a[1:]] == [int(x) for x in b[1:]]
    _poison_allocator(cuda, *sizes)
    got = renderer.march_rays(*inputs, rc)
    want = renderer.march_reference(*inputs, rc)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_march_past_31_bits_takes_the_int64_path(cuda):
    """R x S just above 2^31 (2^21 + 1 rays of S = 1024, 1% of them
    active): the codes of the last rays' samples pass 2^31, which the
    slot kernels' 64-bit division takes, and every kernel holds to its
    plain version as in every case; march_rays equals march_reference."""
    rc = _march_rc()
    R = (1 << 21) + 1
    assert R * rc.max_samples_per_ray > 1 << 31
    binary, o, d, _, jitter = chip_smoke.march_inputs(torch, rc, R, 0.3,
                                                      0.05)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    mask = torch.rand(R, generator=gen, device=cuda) < 0.01
    rows, whole, demand = chip_smoke.march_case(
        torch, "card test past 2^31", "wide", (binary, o, d, mask, jitter),
        rc, timed=False)
    _march_rows_hold(rows, whole)
    assert demand["samples"] > 0


def test_march_wrappers_raise_instead_of_falling_back(cuda):
    from deblur_e_nerf_tpu_torch.ops import march as mo

    rc = chip_smoke.march_render_config(chip_smoke.MARCH_CONFIGS[0][1])
    binary, o, d, mask, jitter = chip_smoke.march_inputs(torch, rc, 64, 0.3,
                                                         0.05)
    with pytest.raises(TypeError, match="bool"):
        mo.masks(binary.float(), rc, True)
    with pytest.raises(ValueError, match="elements"):
        mo.masks(binary[:-1], rc, True)
    pooled = mo.masks(binary, rc, True)[1]
    with pytest.raises(TypeError, match="float32"):
        mo.coarse(mo.SUPERBLOCKS, o.double(), d, mask, jitter, pooled, rc)
    with pytest.raises(ValueError, match="contiguous"):
        mo.coarse(mo.SUPERBLOCKS, o.t().contiguous().t(), d, mask, jitter,
                  pooled, rc)
    with pytest.raises(ValueError, match="jitter"):
        mo.coarse(mo.SUPERBLOCKS, o, d, mask, None, pooled, rc)
    with pytest.raises(ValueError, match="rays on"):
        mo.coarse(mo.SUPERBLOCKS, o, d, mask.cpu(), jitter, pooled, rc)
    with pytest.raises(TypeError, match="int64"):
        mo.decode(torch.zeros(9, dtype=torch.int32, device=cuda),
                  torch.zeros(64, device=cuda), None,
                  torch.zeros((), dtype=torch.int64, device=cuda), 64, rc)


# the occupancy update (csrc/occupancy.cu)


@pytest.mark.parametrize("label,path", chip_smoke.OCC_CONFIGS)
def test_occupancy_kernels_match_plain(cuda, label, path):
    """The four occupancy kernels on each config's geometry at 64^3
    (chip_smoke.occ_cases: warmup, sampled, the sampler's fallback and a
    planted NaN density): points, steps, EMA, sampler and quantile bit for
    bit, the threshold within chip_smoke.OCC_MEAN_RTOL with the cells that
    flip counted, two runs bit for bit, their launches an update, the
    whole update equal to the plain one."""
    rows = chip_smoke.occ_cases(torch, f"card test {label}", path,
                                timed=False, resolution=64)
    for kernel in chip_smoke.OCC_KERNELS:
        assert rows[kernel] and all(r["within_rule"] and r["reproducible"]
                                    for r in rows[kernel])


@pytest.mark.parametrize("contraction", list(contraction.ContractionType))
def test_occupancy_models_on_the_card(cuda, contraction):
    """The per-lane models with the card's division equal the plain
    versions on the card and the kernels, bit for bit: the points and the
    cone step under each contraction, the sampler; and the threshold
    kernel's quantile equals torch.quantile on the card."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = 48
    n = res ** 3
    grid = oo.Grid(res, (-1.0, -2.0, -1.5, 1.0, 2.0, 1.5), contraction)
    steps = oo.Steps(0.004, 0.004, 0.05, 5.0)
    jitter = torch.rand((n, 3), generator=gen, device=cuda)
    cams = torch.rand((9, 3), generator=gen, device=cuda) * 2 - 1
    cam_ids = torch.randint(0, 9, (n,), generator=gen, device=cuda)
    cells = (torch.randint(0, n, (n // 4,), generator=gen, device=cuda),
             torch.randint(0, n, (n // 4,), generator=gen, device=cuda))
    for listed in ((), cells):
        lanes = n if not listed else n // 2
        j = jitter[:lanes].contiguous()
        c = cam_ids[:lanes].contiguous()
        args = (grid, j, 7, lanes - 7, listed, steps, c, cams)
        want = oo.points_reference(*args)
        model = oo.points_model(*args, cuda_division=True)
        got = oo.points(*args)
        for a, b, m in zip(got, want, model):
            assert torch.equal(a, b) and torch.equal(m, b)
    binary = torch.rand(n, generator=gen, device=cuda) < 0.05
    draws = {"u": torch.rand(n // 4, generator=gen, device=cuda),
             "fallback_cells": torch.randint(0, n, (n // 4,), generator=gen,
                                             device=cuda)}
    want = oo.sample_occupied_reference(binary, draws)
    assert torch.equal(oo.sample_occupied(binary, draws), want)
    assert torch.equal(oo.sample_occupied_model(binary, draws), want)
    occs = torch.rand(n, generator=gen, device=cuda) ** 4
    got_occs, partials = oo.ema(occs, 1.0, [], (cells[0][:0],))
    assert torch.equal(got_occs, occs)
    for q in (0.875, 0.5, 1.0 / 3.0):
        _, got = oo.threshold(occs, partials, float("-inf"), 0.0, 0.0,
                              1.0 - q)
        assert torch.equal(got, torch.quantile(occs, q))


@pytest.mark.parametrize("warmup", [True, False])
def test_occupancy_ema_propagates_planted_nan(cuda, warmup):
    """NaN in a density, or in a cell of the grid, reaches the same cells
    as torch.maximum and scatter_reduce(amax) take it there (both
    propagate it), and the threshold is NaN in both (the mask empty)."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 32 ** 3
    occs = torch.rand(n, generator=gen, device=cuda) * 0.01
    occs[[5, 77, 4096]] = float("nan")
    if warmup:
        cells, lanes = None, n
    else:
        cells = (torch.randint(0, n, (n // 4,), generator=gen, device=cuda),
                 torch.tensor([5, 9, 9, 300] * 16, device=cuda))
        lanes = n // 4 + 64
    density = torch.rand((lanes, 1), generator=gen, device=cuda)
    density[[3, lanes - 2]] = float("nan")
    chunks = [(0, density[:4096], None), (4096, density[4096:], None)]
    got, partials = oo.ema(occs, 0.95, chunks, cells, 0.02)
    want, _ = oo.ema_reference(occs, 0.95, chunks, cells, 0.02)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and int(nan.sum()) >= 3
    assert torch.equal(got[~nan], want[~nan])
    binary, thre = oo.threshold(got, partials, 0.01)
    want_b, want_t = oo.threshold_reference(want, 0.01)
    assert torch.isnan(thre) and torch.isnan(want_t)
    assert torch.equal(binary, want_b) and not bool(binary.any())


@pytest.mark.parametrize("n_chunks", [1, 2, 16, 70])
@pytest.mark.parametrize("kind", ["duplicates", "distinct", "one cell",
                                  "nan"])
def test_occupancy_ema_chunk_tables_match_plain(cuda, kind, n_chunks):
    """A sampled EMA over a table of 1, 2, 16 or 70 chunks (two scatter
    launches) bit for bit against ema_reference (NaN equal to NaN), on
    duplicate cells within and across chunks, distinct cells, every lane
    on one cell and NaN densities and cells (chip_smoke.ema_inputs); its
    launches (chip_smoke.ema_launches), the partials within
    chip_smoke.OCC_PARTIALS_RTOL of partials_model, two runs bit for bit,
    and the keys zero again after each update."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    n = 48 ** 3
    occs, cells, chunks = chip_smoke.ema_inputs(kind, n_chunks, n)
    occs, cells = occs.to(cuda), tuple(c.to(cuda) for c in cells)
    chunks = [(i, d.to(cuda), st.to(cuda)) for i, d, st in chunks]
    before = oo.EMA_LAUNCHES
    got, (psum, pmax) = oo.ema(occs, 0.95, chunks, cells, 0.02)
    again, _ = oo.ema(occs, 0.95, chunks, cells, 0.02)
    torch.cuda.synchronize()
    assert oo.EMA_LAUNCHES - before == 2 * chip_smoke.ema_launches(
        n_chunks, False)
    want, _ = oo.ema_reference(occs, 0.95, chunks, cells, 0.02)
    assert chip_smoke._nan_equal(torch, got, want)
    assert chip_smoke._nan_equal(torch, again, got)
    want_sum, want_max = oo.partials_model(want)
    rel = ((psum - want_sum).abs() / want_sum.abs().clamp(min=1e-30))
    assert float(rel.nan_to_num(0.0).max()) <= chip_smoke.OCC_PARTIALS_RTOL
    assert chip_smoke._nan_equal(torch, pmax, want_max)
    # the partials in the kernel's own order, bit for bit
    exact, _ = oo.kernel_partials_model(want, True)
    assert chip_smoke._nan_equal(torch, psum, exact)
    keys, dirty = oo._KEYS[(occs.device, n)]
    assert not dirty and not bool(keys.any())


@pytest.mark.parametrize("range_bytes", [4096, 1 << 16, 1 << 20])
def test_occupancy_ema_scatter_in_cell_ranges(cuda, monkeypatch,
                                              range_bytes):
    """The sampled scatter run range by range (EMA_RANGE_BYTES cut so that
    a 64^3 grid takes 256, 16 and 1 ranges, the last one shorter) gives
    the plain update bit for bit."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    monkeypatch.setattr(oo, "EMA_RANGE_BYTES", range_bytes)
    n = 64 ** 3 + 5
    occs, cells, chunks = chip_smoke.ema_inputs("duplicates", 3, n, seed=4)
    occs, cells = occs.to(cuda), tuple(c.to(cuda) for c in cells)
    chunks = [(i, d.to(cuda), st.to(cuda)) for i, d, st in chunks]
    got, _ = oo.ema(occs, 0.95, chunks, cells, 0.02)
    want, _ = oo.ema_reference(occs, 0.95, chunks, cells, 0.02)
    assert chip_smoke._nan_equal(torch, got, want)


def test_occupancy_quantile_beyond_torch_quantile(cuda):
    """A grid of 2^24 + 1 cells, which torch.quantile refuses: the
    threshold kernel's quantile (occ_thre -inf) bit for bit against the
    order statistics torch.kthvalue finds, at torch.quantile's float32
    rank, interpolated by torch.lerp on the card."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    n = (1 << 24) + 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    occs = torch.rand(n, generator=gen, device=cuda) ** 3 * 0.1
    occs[:1000] = 0.05  # ties
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(occs, 0.5)
    got_occs, partials = oo.ema(occs, 1.0, [], (torch.zeros(
        0, dtype=torch.int64, device=cuda),))
    for frac in (0.125, 0.3, 2.0 / 3.0):
        q = 1.0 - frac
        binary, got = oo.threshold(got_occs, partials, float("-inf"), 0.0,
                                   0.0, frac)
        rank = np.float32(q) * np.float32(n - 1)
        below, above = int(rank), int(np.ceil(rank))
        lo = torch.kthvalue(occs, below + 1).values
        hi = torch.kthvalue(occs, above + 1).values
        want = torch.lerp(lo, hi, torch.tensor(np.float32(rank - below),
                                               device=cuda))
        assert torch.equal(got, want), (frac, float(got), float(want))
        assert torch.equal(binary, occs > want)


def test_occupancy_update_launches_the_kernels_without_a_sync(cuda):
    """models/occupancy.update on card tensors launches the points and
    EMA kernels a chunk, the EMA once more for a sampled update, the
    threshold once and the sampler once (chip_smoke.occupancy_launches)
    and makes no host sync."""
    from deblur_e_nerf_tpu_torch.models import occupancy

    rc, kw = chip_smoke.occ_settings(chip_smoke.OCC_CONFIGS[0][1])
    occ_eval = chip_smoke.occ_eval_of(rc, chip_smoke.occ_density(torch, rc))
    state = occupancy.init_state(rc.grid_resolution, cuda)
    for warmup in (True, False, False):
        draws, cams = chip_smoke.occ_draws(torch, rc, warmup, 0)
        chip_smoke.reset_launches()
        torch.cuda.synchronize()
        with chip_smoke.sync_sites(torch) as sites:
            state = occupancy.update(
                state, occ_eval, warmup, draws, resolution=rc.grid_resolution,
                aabb=rc.aabb, contraction_type=rc.contraction_type,
                camera_positions=cams, **kw)
        torch.cuda.synchronize()
        got = chip_smoke.read_launches()
        want = chip_smoke.occupancy_launches(
            rc, **{"warmups" if warmup else "sampled": 1})
        assert {k: got[k] for k in want} == want
        assert not sites
    assert 0 < float(state.binary.float().mean()) < 1


def test_occupancy_wrappers_raise_instead_of_falling_back(cuda):
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    grid = oo.Grid(16, (-1.0,) * 3 + (1.0,) * 3,
                   contraction.ContractionType.AABB)
    jitter = torch.rand((4096, 3), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        oo.points(grid, jitter.double(), 0, 4096)
    with pytest.raises(ValueError, match="lanes"):
        oo.points(grid, jitter, 4000, 200)
    with pytest.raises(ValueError, match="cam_ids"):
        oo.points(grid, jitter, 0, 4096, (), oo.Steps(0.01, 0.1))
    occs = torch.zeros(4096, device=cuda)
    with pytest.raises(ValueError, match="covered"):
        oo.ema(occs, 0.9, [(0, torch.ones(100, device=cuda), None)])
    with pytest.raises(ValueError, match="multiples"):
        oo.ema(occs, 0.9, [(100, torch.ones(100, device=cuda), None)])
    with pytest.raises(TypeError, match="float32"):
        oo.ema(occs, 0.9, [(0, torch.ones(4096, device=cuda,
                                          dtype=torch.float64), None)])
    with pytest.raises(ValueError, match="partials"):
        oo.threshold(occs, None, 0.01)
    with pytest.raises(TypeError, match="bool"):
        oo.sample_occupied(occs, {"u": torch.rand(8, device=cuda),
                                  "fallback_cells": torch.zeros(
                                      8, dtype=torch.int64, device=cuda)})
