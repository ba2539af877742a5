"""The occupancy update's caps and chain, and the per-lane models of its
kernels (csrc/occupancy.cu): the port against the JAX package with its
draws handed over, and each model (ops/occupancy.py `*_model`) bit for bit
against the plain version it models. 16^3 grids; two JAX compiles for the
module (every cap on, and the r5fix config's caps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deblur_e_nerf_tpu.models import occupancy as jocc
from deblur_e_nerf_tpu.models.contraction import ContractionType as JCT
from deblur_e_nerf_tpu_torch.models import occupancy as tocc
from deblur_e_nerf_tpu_torch.models.contraction import ContractionType
from deblur_e_nerf_tpu_torch.ops import occupancy as oo

RES = 16
N_CELLS = RES ** 3
AABB = (-1.0, -1.5, -1.0, 1.0, 1.5, 1.0)
STEP = 0.02
DECAY = 0.95
WARMUP = 4
# every cap on (each test case makes another one decide), and r5fix's
ALL_CAPS = dict(thre_floor=1e-3, thre_rel_max=0.1, max_occupied_fraction=0.2)
R5FIX_CAPS = dict(thre_floor=1e-3, thre_rel_max=0.0,
                  max_occupied_fraction=0.125)
# occs from the two packages' float32 density and EMA passes: XLA's and
# torch's float32 exp differ by a few ulp (3.8e-6 of a value at most in
# these cases); the threshold's mean sums float32 in each package's own
# order, and its quantile interpolates such occs
OCCS_RTOL = 1e-5
THRE_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_density(x, a, b):
    return a * jnp.exp(-jnp.sum(x * x, axis=-1, keepdims=True) / 0.1) + b


def torch_density(x, a, b):
    return a * torch.exp(-torch.sum(x * x, dim=-1, keepdim=True) / 0.1) + b


def _jax_update(caps):
    def update(state, key, step, a, b):
        occ_eval = jocc.make_occ_eval_fn(
            lambda x: jax_density(x, a, b), STEP, 0.0, None, None)
        return jocc.update(
            state, key, occ_eval, jnp.zeros((1, 3)), step, resolution=RES,
            aabb=AABB, contraction_type=JCT.AABB, occ_thre=0.01,
            ema_decay=DECAY, warmup_steps=WARMUP, **caps)
    return jax.jit(update)


@pytest.fixture(scope="module")
def all_caps_update():
    return _jax_update(ALL_CAPS)


@pytest.fixture(scope="module")
def r5fix_update():
    return _jax_update(R5FIX_CAPS)


def jax_update_draws(key, warmup):
    """The draws jax occupancy.update makes from `key`, for the port."""
    k_sample, k_jitter, _ = jax.random.split(key, 3)
    n = N_CELLS // 4
    if warmup:
        return {"jitter": torch.tensor(np.asarray(jax.random.uniform(
            k_jitter, (N_CELLS, 3), jnp.float32)))}
    k_uniform, k_occ = jax.random.split(k_sample)
    k_fallback, k_occ2 = jax.random.split(k_occ)
    return {
        "uniform_cells": torch.tensor(np.asarray(jax.random.randint(
            k_uniform, (n,), 0, N_CELLS, dtype=jnp.int32))),
        "occupied": {
            "fallback_cells": torch.tensor(np.asarray(jax.random.randint(
                k_fallback, (n,), 0, N_CELLS, dtype=jnp.int32))),
            "u": torch.tensor(np.asarray(jax.random.uniform(
                k_occ2, (n,), jnp.float32))),
        },
        "jitter": torch.tensor(np.asarray(jax.random.uniform(
            k_jitter, (2 * n, 3), jnp.float32))),
    }


def torch_update(state, step, key, a, b, caps):
    warmup = step < WARMUP
    occ_eval = tocc.make_occ_eval_fn(lambda x: torch_density(x, a, b), STEP,
                                     0.0)
    return tocc.update(state, occ_eval, warmup, jax_update_draws(key, warmup),
                       resolution=RES, aabb=AABB,
                       contraction_type=ContractionType.AABB, occ_thre=0.01,
                       ema_decay=DECAY, **caps)


def thresholds(occs, caps):
    """Each candidate of the threshold from occs (float64 numpy): the base
    min(mean, occ_thre) and each cap's."""
    return {"base": min(occs.mean(), 0.01),
            "thre_floor": caps["thre_floor"],
            "thre_rel_max": caps["thre_rel_max"] * occs.max(),
            "max_occupied_fraction": np.quantile(
                occs, 1.0 - caps["max_occupied_fraction"])}


def check_against_jax(ts, js, caps):
    """occs within OCCS_RTOL, the threshold within THRE_RTOL, the masks
    equal but at cells within THRE_RTOL of the threshold; returns the
    threshold (JAX's)."""
    occs = np.asarray(js.occs)
    np.testing.assert_allclose(ts.occs.numpy(), occs, rtol=OCCS_RTOL,
                               atol=1e-12)
    _, t_thre = oo.threshold_reference(ts.occs, 0.01, **caps)
    thre = max(thresholds(occs.astype(np.float64), caps).values())
    assert float(t_thre) == pytest.approx(thre, rel=THRE_RTOL, abs=1e-12)
    differ = ts.binary.numpy() != np.asarray(js.binary)
    assert not differ[np.abs(occs - thre) > THRE_RTOL * thre].any()
    return thre


# (deciding cap, density amplitude a, offset b): a faint field under the
# floor; a peaked one whose max-relative threshold passes its quantile; a
# nearly flat one whose quantile passes the others
CAP_CASES = [("thre_floor", 0.005, 0.001), ("thre_rel_max", 5.0, 0.0),
             ("max_occupied_fraction", 0.5, 2.0)]


@pytest.mark.parametrize("cap,a,b", CAP_CASES)
def test_update_with_every_cap_matches_jax(all_caps_update, cap, a, b):
    """Warmup and sampled updates with the floor, max-relative and
    occupied-fraction caps on, against the JAX package's with its draws
    handed over; in each case the named cap decides the threshold
    (tolerances OCCS_RTOL, THRE_RTOL)."""
    js = jocc.init_state(RES)
    ts = tocc.init_state(RES, "cpu")
    for i, step in enumerate([0, 1, 4, 8]):
        key = jax.random.PRNGKey(40 + i)
        js = all_caps_update(js, key, jnp.asarray(step), a, b)
        ts = torch_update(ts, step, key, a, b, ALL_CAPS)
        check_against_jax(ts, js, ALL_CAPS)
        cands = thresholds(np.asarray(js.occs).astype(np.float64), ALL_CAPS)
        assert max(cands, key=cands.get) == cap, cands
        # carry the JAX state forward so the draws stay comparable
        ts = tocc.OccupancyGridState(torch.tensor(np.asarray(js.occs)),
                                     torch.tensor(np.asarray(js.binary)))


def test_update_chain_empties_the_grid_as_jax_does(r5fix_update):
    """20 updates (4 warmup, then sampled) under r5fix's caps, each package
    carrying its own grid, with the density scaled down by 0.5 each
    update: occs, the threshold and the mask agree at every update
    (OCCS_RTOL, THRE_RTOL), and the grid empties at the same update in
    both."""
    js = jocc.init_state(RES)
    ts = tocc.init_state(RES, "cpu")
    occupied = []
    for step in range(20):
        key = jax.random.PRNGKey(100 + step)
        scale = 0.5 ** step
        js = r5fix_update(js, key, jnp.asarray(step), 0.08 * scale,
                          5e-4 * scale)
        ts = torch_update(ts, step, key, 0.08 * scale, 5e-4 * scale,
                          R5FIX_CAPS)
        check_against_jax(ts, js, R5FIX_CAPS)
        assert np.array_equal(ts.binary.numpy(), np.asarray(js.binary))
        occupied.append((int(ts.binary.sum()), int(np.asarray(
            js.binary).sum())))
    port, jax_counts = zip(*occupied)
    assert port == jax_counts, occupied
    # the grid empties within the chain (at update 10 of 20, in both)
    assert port[0] > 0 and port[-1] == 0, occupied


def test_fallback_when_nothing_is_occupied_matches_jax():
    """The sampler on an empty mask returns the fallback cells, as JAX's
    returns its uniform cells."""
    state = jocc.OccupancyGridState(occs=None,
                                    binary=jnp.zeros(N_CELLS, bool))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(jocc.sample_occupied_cells,
                              static_argnums=2)(key, state, 500))
    k_fallback, k_occ = jax.random.split(key)
    draws = {"fallback_cells": torch.tensor(np.asarray(jax.random.randint(
                 k_fallback, (500,), 0, N_CELLS, dtype=jnp.int32))),
             "u": torch.tensor(np.asarray(jax.random.uniform(
                 k_occ, (500,), jnp.float32)))}
    binary = torch.zeros(N_CELLS, dtype=torch.bool)
    got = tocc.sample_occupied_cells(binary, draws)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(oo.sample_occupied_model(binary, draws),
                                  want)


@pytest.mark.parametrize("q", [0.5, 0.875, 0.8, 1.0 / 3.0, 0.0, 1.0])
@pytest.mark.parametrize("n", [1, 2, 7, 4096, 4097])
def test_quantile_model_between_cells(q, n):
    """quantile_model (the radix select, torch's float32 rank and lerp)
    bit for bit against torch.quantile, where the rank falls between two
    cells and on one, on distinct values, ties and a NaN; and within
    float32 rounding of numpy's and JAX's linear quantile."""
    rng = np.random.default_rng(n)
    cases = {"distinct": rng.uniform(0, 0.1, n),
             "ties": np.round(rng.uniform(0, 0.1, n), 2),
             "signs": rng.normal(size=n) * 1e-3}
    for name, values in cases.items():
        occs = torch.tensor(values, dtype=torch.float32)
        want = torch.quantile(occs, q)
        got = oo.quantile_model(occs, q)
        assert torch.equal(got, want), (name, float(got), float(want))
        ref = np.quantile(values.astype(np.float32).astype(np.float64), q)
        assert float(got) == pytest.approx(ref, rel=1e-6, abs=1e-9)
        jq = float(jnp.quantile(jnp.asarray(values, jnp.float32), q))
        assert float(got) == pytest.approx(jq, rel=1e-6, abs=1e-9)
    occs = torch.tensor(cases["distinct"], dtype=torch.float32)
    occs[n // 2] = float("nan")
    assert torch.isnan(oo.quantile_model(occs, q))
    assert torch.isnan(torch.quantile(occs, q))


def test_order_keys_order_every_float():
    x = torch.tensor([float("-inf"), -2.0, -1e-30, -0.0, 0.0, 1e-45, 1.0,
                      float("inf"), float("nan")])
    keys = oo.order_keys(x)
    assert torch.all(keys[1:] >= keys[:-1]) and int(keys.min()) > 0
    assert int(keys[3]) == int(keys[4])  # -0 as +0
    back = oo.key_values(keys[:-1])
    assert torch.equal(back[x[:-1] != 0], x[:-1][x[:-1] != 0])
    assert torch.isnan(oo.key_values(keys[-1]))


CONTRACTIONS = [ContractionType.AABB, ContractionType.UN_BOUNDED_SPHERE,
                ContractionType.UN_BOUNDED_TANH]
STEPS = [None, oo.Steps(STEP, 0.1), oo.Steps(STEP, 0.1, 0.3, 2.5)]


@pytest.mark.parametrize("contraction", CONTRACTIONS)
@pytest.mark.parametrize("steps", STEPS, ids=["no cone", "cone",
                                              "cone, planes"])
@pytest.mark.parametrize("listed", [False, True],
                         ids=["cell range", "cell lists"])
def test_points_model_matches_plain_bit_for_bit(contraction, steps, listed):
    """points_model (the kernel's operation order lane by lane, the CPU's
    division) equals the plain version's points and steps bit for bit: a
    warmup chunk's cell range and a sampled update's two lists, with and
    without a cone angle and near/far planes."""
    gen = torch.Generator().manual_seed(0)
    grid = oo.Grid(RES, AABB, contraction)
    jitter = torch.rand((N_CELLS, 3), generator=gen)
    cams = torch.rand((7, 3), generator=gen) * 4 - 2
    cam_ids = torch.randint(0, 7, (N_CELLS,), generator=gen)
    cells = ((torch.randint(0, N_CELLS, (N_CELLS // 2,), generator=gen),
              torch.randint(0, N_CELLS, (N_CELLS - N_CELLS // 2,),
                            generator=gen)) if listed else ())
    for start, count in ((0, N_CELLS), (1000, 1500)):
        args = (grid, jitter, start, count, cells, steps, cam_ids, cams)
        x, step = oo.points_reference(*args)
        mx, mstep = oo.points_model(*args)
        assert torch.equal(mx, x)
        assert (step is None and mstep is None) or torch.equal(mstep, step)


def test_sample_occupied_model_matches_plain_bit_for_bit():
    """The sampler's integer group search equals the plain inverse CDF
    (float32 cumsum, searchsorted right, clamp) cell for cell: sparse,
    dense, single-cell and empty masks, variates near 1 and at 0, grids
    not a multiple of a group."""
    gen = torch.Generator().manual_seed(1)
    for n_cells, p in ((N_CELLS, 0.05), (N_CELLS, 0.9), (1000, 0.3),
                       (129, 0.01), (N_CELLS, 0.0)):
        binary = torch.rand(n_cells, generator=gen) < p
        u = torch.rand(3000, generator=gen)
        u[:3] = torch.tensor([0.0, 1.0 - 2 ** -24, 0.99999994])
        draws = {"u": u, "fallback_cells": torch.randint(
            0, n_cells, (3000,), generator=gen)}
        want = oo.sample_occupied_reference(binary, draws)
        assert torch.equal(oo.sample_occupied_model(binary, draws), want)
        if binary.any():
            assert binary[want].all()
    binary = torch.zeros(N_CELLS, dtype=torch.bool)
    binary[N_CELLS - 1] = True
    draws["fallback_cells"] = draws["fallback_cells"] % N_CELLS
    assert torch.equal(oo.sample_occupied_model(binary, draws),
                       torch.full((3000,), N_CELLS - 1))


def _nan_equal(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32),
        torch.where(nan, 0.0, b).view(torch.int32))


@pytest.mark.parametrize("n_chunks", [1, 2, 16, oo.MAX_CHUNKS + 6])
@pytest.mark.parametrize("kind", ["duplicates", "distinct", "one cell",
                                  "nan"])
def test_ema_model_matches_plain_bit_for_bit(kind, n_chunks):
    """The sampled EMA kernels' form (`ema_model`: the contributions'
    order-preserving keys, their maximum a cell, then max(occs x decay,
    the key's float) where a key is set) bit for bit against the plain
    update (NaN equal to NaN), for tables of 1, 2 and 16 chunks and more
    than one scatter launch takes (MAX_CHUNKS), with duplicate cells
    within and across chunks, no cell sampled twice, every lane on one
    cell, and NaN densities and cells (chip_smoke.ema_inputs); the
    partials are the plain `partials_model`'s. The warmup form is the
    plain one."""
    occs, cells, chunks = chip_smoke.ema_inputs(kind, n_chunks, N_CELLS)
    assert len(chunks) == n_chunks
    want, _ = oo.ema_reference(occs, DECAY, chunks, cells, STEP)
    got, _ = oo.ema_model(occs, DECAY, chunks, cells, STEP)
    assert _nan_equal(got, want)
    changed = int((got != occs).sum())
    assert changed > 0 if kind != "one cell" else changed == 1
    if kind == "nan":
        assert int(torch.isnan(want).sum()) >= 3
    chunks = [(0, torch.from_numpy(np.random.default_rng(1).uniform(
        size=N_CELLS).astype(np.float32)), None)]
    assert _nan_equal(oo.ema_model(occs, DECAY, chunks, None, STEP)[0],
                      oo.ema_reference(occs, DECAY, chunks, None, STEP)[0])


@pytest.mark.parametrize("res", [16, 64, 128, 256, 512])
def test_ema_scatter_ranges_cover_the_grid(res):
    """The sampled scatter's cell ranges (`range_cells`): multiples of 32
    cells, as few as keep a range's keys within EMA_RANGE_BYTES, and
    together the whole grid (one range up to the flagship's 128^3, two at
    EDS's 256^3)."""
    n = res ** 3
    cells = oo.range_cells(n)
    ranges = -(-n // cells)
    assert cells % 32 == 0 and ranges * cells >= n > (ranges - 1) * cells
    assert 4 * cells <= oo.EMA_RANGE_BYTES or cells < 32
    assert ranges == max(1, -(-4 * n // oo.EMA_RANGE_BYTES))
    assert ranges == {16: 1, 64: 1, 128: 1, 256: 2, 512: 16}[res]


@pytest.mark.parametrize("caps", [ALL_CAPS, R5FIX_CAPS, {}])
def test_threshold_model_within_tolerance_of_plain(caps):
    """threshold_model (the kernel's float64 partials by tile, the radix
    select) against the plain threshold: the partial sums within 1e-12 of
    a float64 sum, the maxima equal, the threshold within THRE_RTOL and
    the mask equal but at cells within THRE_RTOL of it."""
    gen = torch.Generator().manual_seed(2)
    for n_cells in (N_CELLS, oo.TILE + 5):
        occs = torch.rand(n_cells, generator=gen) ** 4 * 0.05
        psum, pmax = oo.partials_model(occs)
        tiles = -(-n_cells // oo.TILE)
        assert psum.shape == pmax.shape == (tiles,)
        for t in range(tiles):
            part = occs[t * oo.TILE:(t + 1) * oo.TILE]
            assert float(psum[t]) == pytest.approx(
                float(part.double().sum()), rel=1e-12)
            assert float(pmax[t]) == float(part.max())
        binary, thre = oo.threshold_model(occs, 0.01, **caps)
        want_b, want_t = oo.threshold_reference(occs, 0.01, **caps)
        assert float(thre) == pytest.approx(float(want_t), rel=THRE_RTOL)
        differ = binary != want_b
        assert not differ[(occs - want_t).abs() > THRE_RTOL * want_t].any()


@pytest.mark.parametrize("sampled", [False, True])
def test_kernel_partials_model_holds_the_jax_mean(r5fix_update, sampled):
    """The EMA kernels' partials in their own order (`kernel_partials_model`:
    a thread's 4 cells, strided for a warmup chunk and consecutive for a
    sampled update's finish, then the block's pairwise tree): each tile's
    sum within 1e-12 of a float64 sum, the two orders' tile sums within
    1e-12 of each other, and the mean from them within
    chip_smoke.OCC_MEAN_RTOL of the JAX update's jnp.mean on the same
    occs, on a warmup and a sampled update's grid and on a grid whose last
    tile is partial."""
    js = jocc.init_state(RES)
    for i, step in enumerate([0, 1, WARMUP + int(sampled)]):
        js = r5fix_update(js, jax.random.PRNGKey(60 + i), jnp.asarray(step),
                          0.08, 5e-4)
    occs = np.asarray(js.occs)
    for grid in (occs, occs[:oo.TILE + 5]):
        t = torch.from_numpy(grid.copy())
        psum, pmax = oo.kernel_partials_model(t, sampled)
        other, _ = oo.kernel_partials_model(t, not sampled)
        want, want_max = oo.partials_model(t)
        np.testing.assert_allclose(psum.numpy(), want.numpy(), rtol=1e-12)
        np.testing.assert_allclose(other.numpy(), psum.numpy(), rtol=1e-12)
        assert torch.equal(pmax, want_max)
        mean = float(psum.sum()) / grid.shape[0]
        assert mean == pytest.approx(float(jnp.mean(jnp.asarray(grid))),
                                     rel=chip_smoke.OCC_MEAN_RTOL)


def test_census_splits_the_field_from_the_update():
    """op_census counts the update's density calls under "B7 occupancy
    update: field", its other operators under "B7 occupancy update" with
    its kernels' launches (none on the CPU), and a density call outside
    the update under no B7 layer."""
    from types import SimpleNamespace

    from deblur_e_nerf_tpu_torch import op_census
    from deblur_e_nerf_tpu_torch.models import nerf_model

    model = SimpleNamespace(field=SimpleNamespace(
        density=lambda x, level_mask=None: torch_density(x, 5.0, 0.0)))
    occ_eval = tocc.make_occ_eval_fn(
        lambda x: nerf_model.density_fn(model, x), STEP, 0.0)
    state = tocc.init_state(RES, "cpu")
    draws = jax_update_draws(jax.random.PRNGKey(0), True)

    def update():
        nerf_model.density_fn(model, torch.zeros((4, 3)))
        return tocc.update(state, occ_eval, True, draws, resolution=RES,
                           aabb=AABB, contraction_type=ContractionType.AABB,
                           occ_thre=0.01, ema_decay=DECAY, **ALL_CAPS)

    counts, new = op_census.count_ops(update)
    b7 = counts["B7 occupancy update"]
    assert b7["launches"] == dict.fromkeys(
        op_census.LAUNCHES["B7 occupancy update"][1], 0)
    field = counts["B7 occupancy update: field"]["forward"]
    assert field > 0 and b7["forward"] > 0
    # the density call outside the update runs under no layer
    assert counts["other"]["forward"] >= field
    assert new.occs.shape == (N_CELLS,)


def test_census_counts_another_checkout_by_the_same_layers():
    """count_ops(fn, packages) counts the update of another checkout of
    the port (the port imported again under another name, as a parent
    commit's is) by the same layers as the port's own: equal counts
    outside the field and in it; a checkout without a layer's module is
    left out."""
    import importlib
    import importlib.util
    import os
    import sys
    from types import SimpleNamespace

    import deblur_e_nerf_tpu_torch
    from deblur_e_nerf_tpu_torch import op_census
    from deblur_e_nerf_tpu_torch.models import nerf_model

    assert (len(list(op_census._entries(("no_such_checkout",))))
            == len(list(op_census._entries(()))))
    name = "census_other_checkout"
    package = os.path.dirname(deblur_e_nerf_tpu_torch.__file__)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(package, "__init__.py"),
        submodule_search_locations=[package])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(sys.modules[name])
        other = importlib.import_module(f"{name}.models.occupancy")
        model = SimpleNamespace(field=SimpleNamespace(
            density=lambda x, level_mask=None: torch_density(x, 5.0, 0.0)))
        draws = jax_update_draws(jax.random.PRNGKey(1), True)
        counts = []
        for occ, packages in ((tocc, ()), (other, (name,))):
            occ_eval = occ.make_occ_eval_fn(
                lambda x: nerf_model.density_fn(model, x), STEP, 0.0)
            found, new = op_census.count_ops(lambda: occ.update(
                occ.init_state(RES, "cpu"), occ_eval, True, draws,
                resolution=RES, aabb=AABB,
                contraction_type=occ.occ_ops.contraction_lib.ContractionType
                .AABB, occ_thre=0.01, ema_decay=DECAY, **R5FIX_CAPS),
                packages)
            counts.append({k: found[k]["forward"] for k in (
                "B7 occupancy update", "B7 occupancy update: field")})
            assert new.occs.shape == (N_CELLS,)
        assert counts[0] == counts[1] and min(counts[0].values()) > 0
    finally:
        for key in [k for k in sys.modules if k.split(".")[0] == name]:
            del sys.modules[key]
