"""The evaluation slice as a whole: the port's chunked eval render and its
Trainer.evaluate against the JAX package's, from the same parameters and
occupancy grid (carried across with `convert.params_from_jax`), and the
eval-budget divergence the port does not copy from the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu.models import nerf_model as jnerf
from deblur_e_nerf_tpu.models import renderer as jrenderer
from deblur_e_nerf_tpu.training import evaluation as jevaluation
from deblur_e_nerf_tpu.training import setup as jsetup
from deblur_e_nerf_tpu.training.trainer import Trainer as JTrainer
from deblur_e_nerf_tpu.utils.config import load_config as jload_config
from deblur_e_nerf_tpu_torch import convert
from deblur_e_nerf_tpu_torch.models import occupancy as tocc
from deblur_e_nerf_tpu_torch.training import evaluation as tevaluation
from deblur_e_nerf_tpu_torch.training import setup as tsetup
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict

H, W, CHUNK, FIELD_CHUNK = 10, 12, 32, 1000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, where torch's spinning thread pool makes these small
    ops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_config(root, compute_dtype="bfloat16", test_chunk_size=CHUNK):
    """The flagship config cut to test size (filter off): a field with
    dense (4, 8), vertex-hash (16) and cellhash (32-128) levels."""
    cfg = jload_config("configs/train/synthetic.yaml")
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.model.pixel_bandwidth.enable = False
    pe = cfg.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12
    pe.compute_dtype = compute_dtype
    cfg.model.nerf.ngp.mlp_base.n_neurons = 16
    cfg.model.nerf.ngp.mlp_head.n_neurons = 16
    cfg.model.nerf.occ_grid.resolution = 32
    cfg.model.nerf.test_chunk_size = test_chunk_size
    cfg.data.train_init_eff_batch_size = 24
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval_ds")
    jsynthetic.make_dataset(str(root), img_height=32, img_width=32,
                            num_poses=21, num_views=2)
    return root


@pytest.fixture(scope="module")
def lpips_alex_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "alex.pt"
    return chip_smoke.write_lpips_stub(torch, str(path), "alex")


def _textured(params, seed=0):
    """JAX params with a wide random table (the 1e-4 init renders a flat
    image) and a background away from 1."""
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    params["nerf"]["field"]["table"] = rng.normal(
        scale=0.5, size=params["nerf"]["field"]["table"].shape
    ).astype(np.float32)
    params["nerf"]["render_bkgd_raw"] = np.full_like(
        params["nerf"]["render_bkgd_raw"], -0.3)
    return params


def _jax_occupancy(model, nerf_params, T_wc_position):
    return jax.jit(lambda p: jnerf.update_occupancy(
        model, p, jnerf.init_occupancy(model), jax.random.PRNGKey(1),
        T_wc_position, jnp.asarray(0)))(nerf_params)


def _port_occupancy(occ):
    return tocc.OccupancyGridState(torch.tensor(np.asarray(occ.occs)),
                                   torch.tensor(np.asarray(occ.binary)))


def _view(seed):
    """A camera 3 units from the origin looking at it, and its
    intrinsics."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=3)
    pos = (3.0 * pos / np.linalg.norm(pos)).astype(np.float32)
    z = -pos / np.linalg.norm(pos)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z], axis=-1).astype(np.float32)
    K = np.array([[0.8 * W, 0, W / 2 - 0.5], [0, 0.8 * W, H / 2 - 0.5],
                  [0, 0, 1]])
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs, ys], axis=-1).astype(np.float32)
    return pos, R, np.linalg.inv(K).astype(np.float32), pix


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_eval_render_matches_jax_make_render_image_fn(dataset,
                                                       compute_dtype):
    """JAX make_render_image_fn against the port's on a 12x10 image in
    chunks of 32 rays (4 chunks, the last padded by 8), the port's field
    in pieces of 1000 samples (fewer than a chunk's live samples): the
    same per-ray marched sample counts, every pixel within 1e-5."""
    cfg = small_config(dataset, compute_dtype)
    jbundle, jparams = jsetup.build(cfg, str(dataset), sample_budget=4096)
    jparams = _textured(jparams)
    jmodel = jbundle.model
    occ = _jax_occupancy(jmodel, jax.tree_util.tree_map(
        jnp.asarray, jparams["nerf"]),
        jbundle.consts["trajectory"].T_wc_position)
    tbundle, tparams = tsetup.build(ConfigDict.from_dict(cfg.to_dict()),
                                    str(dataset), sample_budget=4096,
                                    device=torch.device("cpu"))
    tparams.load_state_dict(convert.params_from_jax(jparams), strict=True)
    tocc_state = _port_occupancy(occ)
    jrender = jevaluation.make_render_image_fn(jmodel)
    trender = tevaluation.make_render_image_fn(tparams.nerf,
                                               field_chunk=FIELD_CHUNK)

    # the JAX eval render's march, for its per-ray sample counts
    jrc = dataclasses.replace(
        jmodel.render_config, stratified=False,
        sample_budget=CHUNK * jmodel.render_config.max_samples_per_ray,
        block_budget=None, field_chunk=1 << 20)
    jmarch = jax.jit(jrenderer.march_rays, static_argnums=5)
    n_pad = -(-H * W // CHUNK) * CHUNK
    pos, R, Kinv, pix = _view(0)
    img_j = np.asarray(jrender(
        jax.tree_util.tree_map(jnp.asarray, jparams["nerf"]), occ,
        jnp.asarray(Kinv), jnp.asarray(pix), jnp.asarray(pos),
        jnp.asarray(R)))
    img_t = trender(tocc_state, torch.from_numpy(Kinv),
                    torch.from_numpy(pix), torch.from_numpy(pos),
                    torch.from_numpy(R)).numpy()
    stats = trender.stats
    assert stats["ray_chunks"] == 4 and stats["truncated_rays"] == 0
    assert stats["field_chunks"] > stats["ray_chunks"]  # pieces
    assert stats["live_samples"] > 0

    # per-ray counts: the JAX eval march on its rays, the port's on its
    rays_o, rays_d = jnerf.pixel_params_to_ray(
        jnp.asarray(Kinv), jnp.asarray(pix.reshape(-1, 2)),
        jnp.broadcast_to(jnp.asarray(pos), (H * W, 3)),
        jnp.broadcast_to(jnp.asarray(R), (H * W, 3, 3)))
    pad = n_pad - H * W
    rays_o = jnp.concatenate([rays_o, jnp.zeros((pad, 3))])
    rays_d = jnp.concatenate([rays_d, jnp.ones((pad, 3))])
    mask = jnp.arange(n_pad) < H * W
    counts_j = np.concatenate([np.asarray(jmarch(
        occ.binary, rays_o[i:i + CHUNK], rays_d[i:i + CHUNK],
        mask[i:i + CHUNK], jax.random.PRNGKey(0), jrc).counts)
        for i in range(0, n_pad, CHUNK)])[:H * W]
    np.testing.assert_array_equal(stats["counts"].numpy(), counts_j)
    assert int(counts_j.sum()) == stats["live_samples"]

    assert img_t.shape == img_j.shape == (H, W)
    assert np.ptp(img_j) > 0.02  # a textured image, not a flat one
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-5)


def _jax_trainer_and_port(dataset, tmp_path, cfg):
    """A JAX Trainer with a textured table and an updated occupancy grid,
    and the port's Trainer on the CPU with the same parameters and grid."""
    jtr = JTrainer(cfg, str(tmp_path / "jax"), batch_capacity=32,
                   sample_budget=4096)
    params = _textured(jtr.state.params)
    params_j = jax.tree_util.tree_map(jnp.asarray, params)
    occ = _jax_occupancy(jtr.bundle.model, params_j["nerf"],
                         jtr.bundle.consts["trajectory"].T_wc_position)
    jtr.state = jtr.state._replace(params=params_j, occ_state=occ)
    ttr = Trainer(ConfigDict.from_dict(cfg.to_dict()), str(tmp_path / "port"),
                  batch_capacity=32, sample_budget=4096, device="cpu")
    ttr.params.load_state_dict(convert.params_from_jax(params), strict=True)
    ttr.occ_state = _port_occupancy(occ)
    return jtr, ttr


def test_evaluate_matches_jax_trainer_evaluate(dataset, tmp_path,
                                               lpips_alex_weights):
    """JAX Trainer.evaluate("val") against the port's on the CPU, on the
    same tiny synthetic run (32x32 views, 256-ray chunks, LM black-level
    correction, LPIPS with seeded stub weights), twice (the correction's
    warm start): every metric within rtol 1e-4, PSNR within 1e-3 dB."""
    cfg = small_config(dataset, test_chunk_size=256)
    cfg.metric.lpips_weights_path = lpips_alex_weights
    jtr, ttr = _jax_trainer_and_port(dataset, tmp_path, cfg)
    for epoch in (0, 1):
        want = jtr.evaluate("val", epoch)
        got = ttr.evaluate("val", epoch)
        assert set(got) == set(want) == {"l1", "psnr", "ssim", "lpips"}
        for name in want:
            assert np.isfinite(got[name]), name
            assert got[name] == pytest.approx(want[name], rel=1e-4), name
        assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    errors = (tmp_path / "port" / "correction-errors" / "1.csv")
    np.testing.assert_allclose(
        np.loadtxt(errors),
        np.loadtxt(tmp_path / "jax" / "correction-errors" / "1.csv"),
        rtol=1e-4)


def test_eval_resets_superblock_budget_and_warns_on_truncation(
        dataset, capsys):
    """Names the JAX package's eval-budget divergence (ROADMAP Queue C 1).
    A training `superblock_budget` of 1: the JAX eval render keeps it and
    truncates rays without a word (no prepass); the port's resets it and
    renders every ray complete. And with a budget too small for the
    image's demand, the port's eval render warns without a prepass."""
    cfg = small_config(dataset)
    cfg.model.nerf.superblock_budget = 1
    jbundle, jparams = jsetup.build(cfg, str(dataset), sample_budget=4096)
    tbundle, tparams = tsetup.build(ConfigDict.from_dict(cfg.to_dict()),
                                    str(dataset), sample_budget=4096,
                                    device=torch.device("cpu"))
    assert tparams.nerf.render_config.superblock_budget == 1
    empty = jnerf.init_occupancy(jbundle.model)
    occ = empty._replace(occs=jnp.ones_like(empty.occs),
                         binary=jnp.ones_like(empty.binary))  # all occupied
    tocc_state = _port_occupancy(occ)
    pos, R, Kinv, pix = _view(0)
    pix = np.ascontiguousarray(pix[:4, :8])  # one chunk of 32 rays

    trender = tevaluation.make_render_image_fn(tparams.nerf)
    rc = trender.render_config
    assert rc.superblock_budget is None and rc.block_budget is None
    trender(tocc_state, torch.from_numpy(Kinv), torch.from_numpy(pix),
            torch.from_numpy(pos), torch.from_numpy(R))
    assert trender.stats["truncated_rays"] == 0
    assert "WARNING" not in capsys.readouterr().out

    # the JAX eval configuration, as its make_render_image_fn builds it
    jrc = dataclasses.replace(
        jbundle.model.render_config, stratified=False,
        sample_budget=CHUNK * jbundle.model.render_config
        .max_samples_per_ray, block_budget=None, field_chunk=1 << 20)
    assert jrc.superblock_budget == 1
    rays_o, rays_d = jnerf.pixel_params_to_ray(
        jnp.asarray(Kinv), jnp.asarray(pix.reshape(-1, 2)),
        jnp.broadcast_to(jnp.asarray(pos), (CHUNK, 3)),
        jnp.broadcast_to(jnp.asarray(R), (CHUNK, 3, 3)))
    s = jax.jit(jrenderer.march_rays, static_argnums=5)(
        occ.binary, rays_o, rays_d, jnp.ones(CHUNK, bool),
        jax.random.PRNGKey(0), jrc)
    assert not bool(np.all(np.asarray(s.coarse_complete)))

    small = tevaluation.make_render_image_fn(tparams.nerf,
                                             eval_sample_budget=64)
    small(tocc_state, torch.from_numpy(Kinv), torch.from_numpy(pix),
          torch.from_numpy(pos), torch.from_numpy(R))
    assert small.stats["truncated_rays"] > 0
    out = capsys.readouterr().out
    assert f"truncated {small.stats['truncated_rays']} rays" in out


def test_eval_render_with_prepass_matches_jax(dataset, capsys):
    """JAX make_render_image_fn(eval_prepass_div=2) against the port's, on
    the textured field with its density raised (the output bias + 4) so
    that rays terminate and the prepass culls: the same per-ray marched
    counts, fewer live samples than marched, every pixel within 1e-5.
    Then a prepass buffer too small for the live demand (div 16 of a
    4096-sample eval budget, the field as initialized): both packages
    truncate the same number of rays and warn in the same words."""
    cfg = small_config(dataset, "float32")
    jbundle, jparams = jsetup.build(cfg, str(dataset), sample_budget=4096)
    jparams = _textured(jparams)
    bias = np.array(jparams["nerf"]["field"]["mlp_base"]["output"]["bias"])
    bias[0] += 4.0
    jparams["nerf"]["field"]["mlp_base"]["output"]["bias"] = bias
    jmodel = jbundle.model
    nerf_j = jax.tree_util.tree_map(jnp.asarray, jparams["nerf"])
    occ = _jax_occupancy(jmodel, nerf_j,
                         jbundle.consts["trajectory"].T_wc_position)
    _, tparams = tsetup.build(ConfigDict.from_dict(cfg.to_dict()),
                              str(dataset), sample_budget=4096,
                              device=torch.device("cpu"))
    tparams.load_state_dict(convert.params_from_jax(jparams), strict=True)
    tocc_state = _port_occupancy(occ)
    pos, R, Kinv, pix = _view(1)
    jargs = (jnp.asarray(Kinv), jnp.asarray(pix), jnp.asarray(pos),
             jnp.asarray(R))
    targs = (torch.from_numpy(Kinv), torch.from_numpy(pix),
             torch.from_numpy(pos), torch.from_numpy(R))

    jrender = jevaluation.make_render_image_fn(jmodel, eval_prepass_div=2)
    trender = tevaluation.make_render_image_fn(
        tparams.nerf, field_chunk=FIELD_CHUNK, eval_prepass_div=2)
    assert trender.render_config.prepass_budget == CHUNK * 1024 // 2
    img_j = np.asarray(jrender(nerf_j, occ, *jargs))
    img_t = trender(tocc_state, *targs).numpy()
    stats = trender.stats
    assert stats["truncated_rays"] == 0
    assert 0 < stats["live_samples"] < stats["marched_samples"]
    assert stats["density_chunks"] >= stats["ray_chunks"] == 4

    rays_o, rays_d = jnerf.pixel_params_to_ray(
        jnp.asarray(Kinv), jnp.asarray(pix.reshape(-1, 2)),
        jnp.broadcast_to(jnp.asarray(pos), (H * W, 3)),
        jnp.broadcast_to(jnp.asarray(R), (H * W, 3, 3)))
    n_pad = -(-H * W // CHUNK) * CHUNK
    pad = n_pad - H * W
    rays_o = jnp.concatenate([rays_o, jnp.zeros((pad, 3))])
    rays_d = jnp.concatenate([rays_d, jnp.ones((pad, 3))])
    mask = jnp.arange(n_pad) < H * W
    jrc = dataclasses.replace(
        jmodel.render_config, stratified=False,
        sample_budget=CHUNK * jmodel.render_config.max_samples_per_ray,
        block_budget=None, field_chunk=1 << 20)
    counts_j = np.concatenate([np.asarray(jax.jit(
        jrenderer.march_rays, static_argnums=5)(
        occ.binary, rays_o[i:i + CHUNK], rays_d[i:i + CHUNK],
        mask[i:i + CHUNK], jax.random.PRNGKey(0), jrc).counts)
        for i in range(0, n_pad, CHUNK)])[:H * W]
    np.testing.assert_array_equal(stats["counts"].numpy(), counts_j)
    assert int(counts_j.sum()) == stats["marched_samples"]
    assert np.ptp(img_j) > 0.02
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-5)
    assert "WARNING" not in capsys.readouterr().out

    # a prepass buffer of 256 live samples a chunk: truncation, reported
    jbundle, jparams = jsetup.build(cfg, str(dataset), sample_budget=4096)
    nerf_j = jax.tree_util.tree_map(jnp.asarray, jparams["nerf"])
    tparams.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    jsmall = jevaluation.make_render_image_fn(
        jmodel, eval_sample_budget=4096, eval_prepass_div=16)
    tsmall = tevaluation.make_render_image_fn(
        tparams.nerf, eval_sample_budget=4096, eval_prepass_div=16)
    img_j = np.asarray(jsmall(nerf_j, occ, *jargs))
    out_j = capsys.readouterr().out
    img_t = tsmall(tocc_state, *targs).numpy()
    out_t = capsys.readouterr().out
    n = tsmall.stats["truncated_rays"]
    assert n > 0
    warning = (f"WARNING: eval prepass truncated {n} rays (live demand "
               f"exceeded sample_budget/16); raise the budget or lower "
               "eval_occlusion_prepass_div")
    assert warning in out_j and warning in out_t
    # the rays both keep whole render alike
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-5)
