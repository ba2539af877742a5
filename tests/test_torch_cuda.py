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
from deblur_e_nerf_tpu_torch.ops import corner_sum, gather_rows, scatter_rows

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
    """The encode's features (bf16 rows through the kernel, sample-major
    vertex-hash levels) and table gradient on the card against the plain
    version on the CPU: the gathered values agree bit for bit, the 8-term
    float32 sums and the scatter-adds may run in another order."""
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
        before, sums = gather_rows.LAUNCHES, corner_sum.LAUNCHES
        feat = hash_encoding.encode(t, u.to(device), levels,
                                    compute_dtype=torch.bfloat16)
        (feat * cot.to(device)).sum().backward()
        if device == cuda:
            assert gather_rows.LAUNCHES == before + len(levels)
            assert corner_sum.LAUNCHES == sums + len(levels)
        outs[str(device)] = (feat.detach().cpu(), t.grad.cpu())
    # tests/test_torch_hash_encoding.py's tolerances against the JAX encode
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    scale = float(outs["cpu"][1].abs().max())
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=1e-4,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("rows_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [100003, 37])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_corner_sum_kernel_matches_its_model_bit_for_bit(cuda, f, n,
                                                          rows_dtype):
    """The corner sum against the plain model of its order (products
    rounded, corners summed in order) bit for bit, on the card, at a
    ragged N and at one below a block."""
    gen = torch.Generator(device=cuda).manual_seed(f)
    rows = torch.randn((n, 8, f), generator=gen, device=cuda).to(rows_dtype)
    w = torch.rand((n, 8), generator=gen, device=cuda)
    before = corner_sum.LAUNCHES
    out = corner_sum.corner_sum(rows, w)
    torch.cuda.synchronize()
    assert corner_sum.LAUNCHES == before + 1
    model = corner_sum.corner_sum_sequential(rows, w)
    assert out.dtype == torch.float32 and out.shape == (n, f)
    assert torch.equal(chip_smoke._bits(torch, out),
                       chip_smoke._bits(torch, model))


def test_corner_sum_wrapper_raises_instead_of_falling_back(cuda):
    rows = torch.zeros((64, 8, 2), device=cuda)
    w = torch.zeros((64, 8), device=cuda)
    with pytest.raises(TypeError):
        corner_sum.corner_sum(rows.half(), w)
    with pytest.raises(TypeError):
        corner_sum.corner_sum(rows, w.double())
    with pytest.raises(ValueError):  # F = 3 has no instance
        corner_sum.corner_sum(torch.zeros((64, 8, 3), device=cuda), w)
    with pytest.raises(ValueError):  # not contiguous
        corner_sum.corner_sum(torch.zeros((64, 8, 4), device=cuda)[..., ::2],
                              w)
    with pytest.raises(ValueError):  # not 16-byte aligned
        corner_sum.corner_sum(torch.zeros(64 * 8 * 2 + 1, device=cuda)[1:]
                              .reshape(64, 8, 2), w)


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
    """K3 and the corner sum as an eval field call runs them (N = 2^20
    samples, no gradient): bit for bit against their plain versions."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n_rows)
    table = torch.randn((n_rows, width), generator=gen, device=cuda)
    idx = chip_smoke.k3_indices(torch, "uniform", n, n_rows)
    with torch.no_grad():
        rows = gather_rows.gather_rows(table, idx, round_to)
        plain = gather_rows.gather_rows_reference(table, idx, round_to)
        assert torch.equal(chip_smoke._bits(torch, rows),
                           chip_smoke._bits(torch, plain))
        # a level's (N, 8, F = 2) corner rows: 8 vertex rows, or one
        # cellhash row of 8F
        corners = rows.reshape(-1, 8, 2)
        w = torch.rand(corners.shape[:2], generator=gen, device=cuda)
        out = corner_sum.corner_sum(corners, w)
        model = corner_sum.corner_sum_sequential(corners, w)
        assert torch.equal(chip_smoke._bits(torch, out),
                           chip_smoke._bits(torch, model))


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
