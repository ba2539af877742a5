"""The fused grid encode (ops/hash_encode.py) on the CPU, where it runs its
plain versions: the forward against JAX `_encode_frozen_pos` and the
backward against its table gradient from `jax.vjp`, for all five otypes in
float32 and bf16, on positions outside the cube, on its faces and at u =
1.0 (a dense level's clipped last cell, frac = 1.0); the plain model of
the forward kernel's order against float64; the argument errors; and that
nothing launches on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import hash_encoding as jhe
from deblur_e_nerf_tpu_torch.models import hash_encoding
from deblur_e_nerf_tpu_torch.ops import hash_encode

EPS = float(np.finfo(np.float32).eps)

# (n_levels, base_resolution, per_level_scale, log2_hashmap_size) per otype
LAYOUTS = {
    "DenseGrid": (3, 4, 2.0, 12),
    "HashGrid": (5, 4, 2.0, 10),       # dense 4, 8; hash 16, 32, 64
    "TiledGrid": (5, 4, 2.0, 10),      # dense 4, 8; tiled 16, 32, 64
    "CellHashGrid": (5, 4, 2.0, 10),   # dense 4, 8; cellhash 16, 32, 64
    "HybridHashGrid": (6, 4, 2.0, 10),  # dense 4, 8; hash 16; cellhash 32+
}


def _inputs(otype, n=4000, seed=0):
    levels, total = hash_encoding.grid_layout(otype, *LAYOUTS[otype])
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (total, 2)).astype(np.float32)
    u = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    u[:40] = np.round(u[:40])          # corners of the cube
    u[40:80, 0] = 1.0                  # a face: the clipped last cell
    u[80:120, 1] = 0.0
    u[120:160] = 1.0 + rng.uniform(0, 0.5, (40, 3))  # beyond the cube
    g = rng.normal(size=(n, 2 * len(levels))).astype(np.float32)
    g[-500:] = 0.0                     # empty slots: zero cotangents
    return levels, table, u, g


def _jax(levels, table, u, g, compute_dtype):
    def f(t):
        return jhe._encode_frozen_pos(tuple(levels), t, jnp.asarray(u),
                                      compute_dtype)

    out, vjp = jax.vjp(f, jnp.asarray(table))
    (grad,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("otype", sorted(LAYOUTS))
def test_plain_versions_match_jax(otype, bf16):
    levels, table, u, g = _inputs(otype)
    modes = {m for *_, m in levels}
    assert "dense" in modes and (otype == "DenseGrid" or len(modes) > 1)
    out_j, grad_j = _jax(levels, table, u, g,
                         jnp.bfloat16 if bf16 else None)
    out = hash_encode.encode_forward(
        torch.from_numpy(table), torch.from_numpy(u), levels,
        torch.bfloat16 if bf16 else None)
    grad = hash_encode.encode_backward(torch.from_numpy(g),
                                       torch.from_numpy(u), levels,
                                       table.shape[0])
    # features: the same (rounded) table values and float32 weights, the 8
    # products summed in another order
    assert out.dtype == torch.float32 and out.shape == out_j.shape
    np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-5, atol=1e-6)
    # table gradient: the JAX sort path sums each row near-exactly, the
    # plain version in float32 in index order: (k-1) eps sum|x| per row
    assert grad.dtype == torch.float32 and grad.shape == grad_j.shape
    scale = float(np.abs(grad_j).max())
    np.testing.assert_allclose(grad.numpy(), grad_j, rtol=1e-4,
                               atol=1e-5 * scale)
    assert np.count_nonzero(grad.numpy()) > 0


def test_dense_last_cell_reads_the_far_corner_at_u_one():
    """u = 1.0 on a dense level: the cell is clipped to res - 1 and frac
    reaches 1.0, so the feature is the far corner's row itself."""
    levels, table, _, _ = _inputs("DenseGrid")
    res, _, offset, mode = levels[0]
    assert mode == "dense"
    u = torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.0, 0.0]])
    rows, w = hash_encode.level_rows_weights(u, res, 0, offset, mode,
                                             torch.float32)
    far = offset + (res * (res + 1) + res) * (res + 1) + res
    assert rows[0, 7] == far and w[0, 7] == 1.0 and w[0].sum() == 1.0
    assert rows[1, 4] == offset + res and w[1, 4] == 1.0
    out = hash_encode.encode_forward(torch.from_numpy(table), u, levels[:1])
    assert torch.equal(out[0], torch.from_numpy(table[far]))


@pytest.mark.parametrize("otype,bf16", [("HybridHashGrid", True),
                                        ("HashGrid", False),
                                        ("TiledGrid", True)])
def test_order_model_within_the_order_bound_of_float64(otype, bf16):
    """The plain model of the forward kernel's order (products rounded,
    corners summed k = 0..7) against the same rounded values and float32
    weights summed in float64: within the 8-term order bound 7 eps
    sum|w x| (products and sums rounded: at most 4 eps); and the plain
    version within the same bound of the model."""
    levels, table, u, _ = _inputs(otype)
    compute_dtype = torch.bfloat16 if bf16 else None
    t, uu = torch.from_numpy(table), torch.from_numpy(u)
    model = hash_encode.encode_forward_model(t, uu, levels, compute_dtype)
    plain = hash_encode.encode_forward_reference(t, uu, levels,
                                                 compute_dtype)
    uc = torch.clamp(uu, 0.0, 1.0)
    exact, abs_sum = [], []
    for level in levels:
        rows, w = hash_encode.level_rows_weights(uc, *level, torch.float32)
        values = t[rows]
        if bf16:
            values = values.to(torch.bfloat16).float()
        terms = values.double() * w.double()[..., None]
        exact.append(terms.sum(dim=1))
        abs_sum.append(terms.abs().sum(dim=1))
    exact, bound = torch.cat(exact, -1), 7 * EPS * torch.cat(abs_sum, -1)
    assert bool(((model.double() - exact).abs() <= bound).all())
    diff = (plain.double() - model.double()).abs()
    assert bool((diff <= 2 * bound).all())
    # another order than the plain version's on some entries
    assert not torch.equal(model, plain) or otype == "TiledGrid"


def test_backward_within_the_order_bound_of_float64():
    """The plain backward's float32 row sums against the same float32
    contributions summed in float64: within (k-1) eps sum|x| per row, k
    the row's count of non-zero contributions."""
    levels, table, u, g = _inputs("HybridHashGrid")
    gg, uu = torch.from_numpy(g), torch.from_numpy(u)
    grad = hash_encode.encode_backward(gg, uu, levels, table.shape[0])
    exact = hash_encode.encode_backward_reference(
        gg, uu, levels, table.shape[0], sum_dtype=torch.float64)
    abs_sum = hash_encode.encode_backward_reference(
        gg.abs(), uu, levels, table.shape[0], sum_dtype=torch.float64)
    # k: each row's count of non-zero contributions
    uc = torch.clamp(uu, 0.0, 1.0)
    k = torch.zeros(table.shape[0], dtype=torch.int64)
    for li, level in enumerate(levels):
        rows, w = hash_encode.level_rows_weights(uc, *level, torch.float32)
        live = (w[..., None] * gg[:, None, 2 * li:2 * li + 2] != 0).any(-1)
        k.index_add_(0, rows[live], torch.ones_like(rows[live]))
    bound = (k - 1).clamp(min=0)[:, None] * EPS * abs_sum
    assert bool(((grad.double() - exact).abs() <= bound).all())
    assert int(k.max()) > 1


def test_encode_autograd_goes_through_both_ops():
    """models/hash_encoding.encode: its features are the forward op's, its
    table gradient the backward op's, its position cotangent zero."""
    levels, table, u, g = _inputs("HybridHashGrid", n=600)
    t = torch.from_numpy(table).requires_grad_(True)
    uu = torch.from_numpy(u).requires_grad_(True)
    out = hash_encoding.encode(t, uu.reshape(20, 30, 3), levels,
                               compute_dtype=torch.bfloat16)
    assert out.shape == (20, 30, 2 * len(levels))
    (out.reshape(600, -1) * torch.from_numpy(g)).sum().backward()
    want = hash_encode.encode_forward(t.detach(), uu.detach(), levels,
                                      torch.bfloat16)
    assert torch.equal(out.detach().reshape(600, -1), want)
    assert torch.equal(t.grad, hash_encode.encode_backward(
        torch.from_numpy(g), uu.detach(), levels, table.shape[0]))
    assert torch.count_nonzero(uu.grad) == 0


def test_float64_table_on_the_cpu():
    """The plain versions keep the table's float64 when no rounding is
    asked for (the exactness tests' mode)."""
    levels, table, u, g = _inputs("CellHashGrid", n=500)
    t, uu = torch.from_numpy(table).double(), torch.from_numpy(u)
    out = hash_encode.encode_forward(t, uu, levels)
    grad = hash_encode.encode_backward(torch.from_numpy(g).double(), uu,
                                       levels, table.shape[0])
    assert out.dtype == grad.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), hash_encode.encode_forward(
        t.float(), uu, levels).numpy(), rtol=1e-5, atol=1e-6)


def test_argument_errors_and_no_launch_on_the_cpu():
    levels, table, u, g = _inputs("HybridHashGrid", n=400)
    t, uu, gg = (torch.from_numpy(a) for a in (table, u, g))
    before = (hash_encode.FORWARD_LAUNCHES, hash_encode.BACKWARD_LAUNCHES)
    hash_encode.encode_forward(t, uu, levels, torch.bfloat16)
    hash_encode.encode_backward(gg, uu, levels, t.shape[0])
    assert (hash_encode.FORWARD_LAUNCHES,
            hash_encode.BACKWARD_LAUNCHES) == before
    with pytest.raises(ValueError):  # positions not (N, 3)
        hash_encode.encode_forward(t, uu[:, :2], levels)
    with pytest.raises(ValueError):  # table not (T, F)
        hash_encode.encode_forward(t[:, 0], uu, levels)
    with pytest.raises(TypeError):  # only bf16 rounding
        hash_encode.encode_forward(t, uu, levels, torch.float16)
    with pytest.raises(TypeError):
        hash_encode.encode_forward(t.half(), uu, levels)
    with pytest.raises(ValueError):  # a level beyond the table
        hash_encode.encode_forward(t[:1000], uu, levels)
    with pytest.raises(ValueError):  # a misaligned cellhash segment
        res, size, offset, mode = levels[-1]
        hash_encode.encode_forward(t, uu, levels[:-1] + [
            (res, size - 8, offset + 4, mode)])
    with pytest.raises(ValueError):  # an unknown mode
        hash_encode.encode_forward(t, uu, [(4, 125, 0, "sparse")])
    with pytest.raises(ValueError):  # cotangent width not L * F
        hash_encode.encode_backward(gg[:, :-1], uu, levels, t.shape[0])
    with pytest.raises(ValueError):  # cotangent and positions disagree
        hash_encode.encode_backward(gg[:10], uu, levels, t.shape[0])
    with pytest.raises(TypeError):
        hash_encode.encode_backward(gg.int(), uu, levels, t.shape[0])


@pytest.mark.parametrize("kind", ["uniform", "rays"])
def test_chip_smoke_encode_inputs_and_backward_check_on_the_cpu(kind):
    """chip_smoke.py phase 3's encode inputs and its backward check, with
    the plain backward standing in for the kernel: the ray-ordered
    samples run in order and end in an empty-slot tail, and the plain
    float32 backward passes the check that the kernel must pass."""
    import chip_smoke

    levels, total = hash_encoding.grid_layout(*("HybridHashGrid",)
                                              + LAYOUTS["HybridHashGrid"])
    gen = torch.Generator().manual_seed(0)
    n = 5000
    u, live = chip_smoke.encode_positions(torch, kind, n, gen, "cpu")
    assert u.shape == (n, 3) and live.dtype == torch.bool
    if kind == "rays":
        n_live = int(live.sum())
        assert n_live == 3000 and bool(live[:n_live].all())
        assert torch.equal(u[n_live:], u[n_live - 1].expand(n - n_live, 3))
        step = (u[1:chip_smoke.RAY_SAMPLES] - u[:chip_smoke.RAY_SAMPLES - 1]
                ).norm(dim=-1)
        torch.testing.assert_close(step, torch.full_like(
            step, 3 ** 0.5 / 1024), rtol=1e-3, atol=1e-7)
    g = torch.randn((n, 2 * len(levels)), generator=gen) * live[:, None]
    grad = hash_encode.encode_backward(g, u, levels, total)
    err, within, max_k, atomics = chip_smoke.check_encode_backward(
        torch, grad, g, u, levels)
    assert within and max_k > 1 and 0 <= err
    modes = [m for *_, m in levels]
    assert atomics == int(live.sum()) * sum(
        4 if m == "cellhash" else 8 for m in modes)
    # the two layouts phase 3 runs: the flagship's, EDS/r5fix's
    layout = chip_smoke.encode_layout(torch, chip_smoke.flagship_config("x"))
    assert layout[1] == 6301184 and layout[2] == torch.bfloat16
    levels, _, dtype = chip_smoke.encode_layout(
        torch, chip_smoke.load_with_changes(chip_smoke.EDS_TRAIN_CONFIG, {}))
    assert [m for *_, m in levels] == ["dense"] * 5 + ["hash"] * 11
    assert dtype is None


@pytest.mark.parametrize("otype", sorted(LAYOUTS))
def test_plain_forward_on_the_bf16_copy_is_bit_equal(otype):
    """The card's bf16 forward reads `table.to(torch.bfloat16)`: the plain
    forward (and the model of the kernel's order) on that copy equals the
    plain forward on the float32 table with compute_dtype bf16, bit for
    bit (both round to nearest even)."""
    levels, table, u, _ = _inputs(otype)
    t, uu = torch.from_numpy(table), torch.from_numpy(u)
    copy = t.to(torch.bfloat16)
    for fn in (hash_encode.encode_forward, hash_encode.encode_forward_model):
        want = fn(t, uu, levels, torch.bfloat16)
        for compute_dtype in (torch.bfloat16, None):
            got = fn(copy, uu, levels, compute_dtype)
            assert got.dtype == torch.float32
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _cell_centres(cells, res):
    return (torch.as_tensor(cells, dtype=torch.float32) + 0.5) / res


def test_x_pair_rule_on_each_vertex_mode():
    """`x_pairs`: corners k and k + 4 share one aligned row pair. A hash
    level of power-of-two size pairs every even x as row ^ 1 and no odd
    x; a dense
    level pairs where row_k is even (row_{k+4} = row_k + 1); a tiled
    level of a non-power-of-two size does not pair where the flat index
    wraps, nor a hash level of an odd size as a rule."""
    rng = np.random.default_rng(3)
    res = 16
    cells = rng.integers(0, res, (2000, 3))
    uc = _cell_centres(cells, res)
    x_even = torch.from_numpy(cells[:, 0] % 2 == 0)
    # hash, 1024 rows at a 128-aligned offset
    rows, _ = hash_encode.level_rows_weights(uc, res, 1024, 384, "hash",
                                             torch.float32)
    pairs = hash_encode.x_pairs(rows)
    assert torch.equal(rows[x_even][:, 4:], rows[x_even][:, :4] ^ 1)
    assert bool(pairs[x_even].all())
    assert not bool(pairs[~x_even].any())  # x ^ (x + 1) flips bit 1
    # dense: the x-neighbour is the next row
    rows, _ = hash_encode.level_rows_weights(uc, res, 17 ** 3, 128, "dense",
                                             torch.float32)
    assert torch.equal(rows[:, 4:], rows[:, :4] + 1)
    assert torch.equal(hash_encode.x_pairs(rows), rows[:, :4] % 2 == 0)
    # tiled, 1001 rows: the wrap from local row 1000 (even) to 0
    stride = res + 1
    flat = lambda c: (c[2] * stride + c[1]) * stride + c[0]
    wrap = next(c for c in np.ndindex(res, res, res)
                if flat(c) % 1001 == 1000 and c[0] < res)
    offset = 256
    rows, _ = hash_encode.level_rows_weights(
        _cell_centres([wrap], res), res, 1001, offset, "tiled",
        torch.float32)
    assert int(rows[0, 0]) == offset + 1000 and int(rows[0, 4]) == offset
    assert not bool(hash_encode.x_pairs(rows)[0, 0])
    rows, _ = hash_encode.level_rows_weights(uc, res, 1001, offset, "tiled",
                                             torch.float32)
    wraps = (rows[:, 4:] != rows[:, :4] + 1)
    assert not bool(hash_encode.x_pairs(rows)[wraps & (rows[:, :4] % 2 == 0)]
                    .any())
    # hash of a non-power-of-two size: an even size keeps the pairs of
    # even x (h ^ 1 = h +- 1 keeps its quotient), an odd one does not
    rows, _ = hash_encode.level_rows_weights(uc, res, 1000, 384, "hash",
                                             torch.float32)
    assert bool(hash_encode.x_pairs(rows)[x_even].all())
    rows, _ = hash_encode.level_rows_weights(uc, res, 1001, 384, "hash",
                                             torch.float32)
    assert 0.3 < float(hash_encode.x_pairs(rows)[x_even].float().mean()) \
        < 0.7


def _hand_count(g, u, levels):
    """The backward kernel's reductions counted lane by lane, warp by warp
    (the rules of `backward_reductions`, in loops)."""
    uc = torch.clamp(u, 0.0, 1.0)
    counts = {}
    for li, level in enumerate(levels):
        res, _, _, mode = level
        rows, w = hash_encode.level_rows_weights(uc, *level, torch.float32)
        gl = g[:, 2 * li:2 * li + 2]
        nz = ((w[..., None] * gl[:, None]) != 0).any(-1)
        cells = torch.floor(uc * res)
        if mode == "dense":
            cells = cells.clamp(0, res - 1)
        c = counts.setdefault(mode, {"x2": 0, "x4": 0, "bulk64": 0})
        for start in range(0, u.shape[0], 32):
            groups = {}
            for i in range(start, min(start + 32, u.shape[0])):
                if not bool((gl[i] != 0).any()):
                    continue  # a lane with nothing to add
                key = (int(rows[i, 0]) if mode == "cellhash"
                       else tuple(int(x) for x in cells[i]))
                groups.setdefault(key, []).append(i)
            for lanes in groups.values():
                if mode == "cellhash":
                    c["bulk64"] += any(bool(nz[i].any()) for i in lanes)
                    continue
                assert all(torch.equal(rows[i], rows[lanes[0]])
                           for i in lanes)
                for k in range(4):
                    ra, rb = int(rows[lanes[0], k]), int(rows[lanes[0],
                                                              k + 4])
                    a = any(bool(nz[i, k]) for i in lanes)
                    b = any(bool(nz[i, k + 4]) for i in lanes)
                    if ra // 2 == rb // 2 and ra != rb:
                        c["x4"] += a and b
                        c["x2"] += a != b
                    elif ra == rb:
                        c["x2"] += a or b
                    else:
                        c["x2"] += a + b
    return counts


@pytest.mark.parametrize("otype", ["HybridHashGrid", "TiledGrid"])
def test_backward_reduction_count_against_a_hand_count(otype):
    """`backward_reductions` on 64 samples (two warps): runs of samples
    along x (lanes sharing cells, rows and units), samples on grid planes
    (zero weights), zero and partly zero cotangents; against the same
    rules counted lane by lane."""
    levels, _ = hash_encoding.grid_layout(otype, *LAYOUTS[otype])
    rng = np.random.default_rng(5)
    u = np.empty((64, 3), np.float32)
    for run in range(4):  # 16 samples a run along x
        start = rng.uniform(0.05, 0.6, 3)
        u[16 * run:16 * (run + 1)] = start + np.outer(np.arange(16) / 64,
                                                      [1, 0, 0])
    u[5] = [0.25, 0.5, 0.125]    # on grid planes of every level
    u[40] = [1.0, 1.0, 1.0]
    g = rng.normal(size=(64, 2 * len(levels))).astype(np.float32)
    g[48:] = 0.0                 # empty slots
    g[10, :4] = 0.0              # levels 0-1 of one sample
    g[20, ::2] = 0.0             # one feature of every level
    uu, gg = torch.from_numpy(u), torch.from_numpy(g)
    got = hash_encode.backward_reductions(gg, uu, levels)
    want = _hand_count(gg, uu, levels)
    assert got == want
    modes = {m for *_, m in levels}
    assert set(got) == modes
    # combining and pairing both happened: fewer reductions than
    # contributions, and F32x4s on the vertex levels
    vertex = [c for m, c in got.items() if m != "cellhash"]
    assert sum(c["x4"] for c in vertex) > 0
    total = sum(sum(c.values()) for c in got.values())
    live = int((gg.reshape(64, -1, 2) != 0).any(-1).sum())
    assert total < 8 * live


def test_chip_smoke_captures_the_encode_inputs_of_a_backward():
    """chip_smoke's capture of the step's encode inputs: the positions and
    cotangent that reach `encode_backward`, with the layout, the first
    call only; the wrapper is gone after the block."""
    import chip_smoke

    levels, table, u, g = _inputs("HybridHashGrid", n=300)
    real = hash_encode.encode_backward
    store = {}
    t = torch.from_numpy(table).requires_grad_(True)
    with chip_smoke.capture_encode_inputs(store):
        for _ in range(2):
            out = hash_encoding.encode(t, torch.from_numpy(u), levels)
            (out * torch.from_numpy(g)).sum().backward()
    assert hash_encode.encode_backward is real
    assert torch.equal(store["u"], torch.from_numpy(u))
    assert torch.equal(store["g"], torch.from_numpy(g))
    assert store["levels"] == tuple(levels)
    assert store["table_rows"] == table.shape[0]


def test_bf16_table_copy_is_made_once_per_change():
    """`bf16_table` (the card's bf16 forward reads it): one copy for two
    calls on an unchanged table, a new one after an optimizer step (an
    in-place write) and for another tensor; the copy is the rounding."""
    from deblur_e_nerf_tpu_torch.training.optim import Optimizer

    _, table, _, _ = _inputs("HybridHashGrid", n=200)
    t = torch.nn.Parameter(torch.from_numpy(table))
    opt = Optimizer([("default", 1e-2, 0.0, [("table", t)])], [], 1.0)
    before = hash_encode.BF16_COPIES
    a = hash_encode.bf16_table(t)
    assert hash_encode.bf16_table(t) is a
    assert hash_encode.BF16_COPIES == before + 1
    assert torch.equal(a, t.detach().to(torch.bfloat16))
    t.grad = torch.ones_like(t)
    opt.step()
    b = hash_encode.bf16_table(t)
    assert b is not a and hash_encode.BF16_COPIES == before + 2
    assert torch.equal(b, t.detach().to(torch.bfloat16))
    other = t.detach().clone()
    hash_encode.bf16_table(other)
    assert hash_encode.BF16_COPIES == before + 3
