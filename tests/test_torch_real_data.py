"""The real-data (EDS) training path against the JAX package: one step of
configs/train/07_ziggy_and_fuzz_hdr.yaml at test size (sphere contraction,
cone angle 0.004, float32 HashGrid gathers, the pixel-bandwidth filter on
with its six parameters trainable, a distorted calibration), and
chip_smoke.py's phase 7: its config against the YAML files, its card-vs-CPU
step on the CPU."""

import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke
from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu.utils.config import load_config as jload_config
from deblur_e_nerf_tpu_torch.models import renderer as trenderer
from deblur_e_nerf_tpu_torch.training import step as tstep
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict
from test_torch_train_step import (_assert_port_step_matches,
                                   _hand_jax_samples_to_port, _jax_step)

EDS_TRAIN = "configs/train/07_ziggy_and_fuzz_hdr.yaml"
EDS_TEST = "configs/test/07_ziggy_and_fuzz_hdr.yaml"
DISTORTION = [-0.1, 0.02, 1e-3, -1e-3]
COMPONENTS = ("contrast_threshold", "refractory_period", "pixel_bandwidth",
              "nerf")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, where torch's spinning thread pool makes these small
    ops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def distort_calibration(root):
    """Rewrite the dataset's calibration with a plumb_bob distortion (the
    EDS sequences' calibrations are distorted)."""
    path = os.path.join(str(root), "camera_calibration.npz")
    calib = dict(np.load(path))
    calib["distortion_model"] = np.array("plumb_bob")
    calib["distortion_params"] = np.array(DISTORTION)
    np.savez(path, **calib)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eds_ds")
    jsynthetic.make_dataset(str(root), img_height=32, img_width=32,
                            num_poses=21, num_views=2)
    distort_calibration(root)
    return root


def eds_config(root, it_sample_size=4, active=24, far_plane=None):
    """The EDS train config at test size: 6 HashGrid levels of <= 2^12
    rows (dense 4, 8, 16; hashed 32-128), float32 gathers, 16-wide MLPs,
    a 16^3 grid; everything else as written (sphere, cone 0.004, near
    0.01, far 13 unless `far_plane`, the filter on and trainable,
    accumulation 8)."""
    cfg = jload_config(EDS_TRAIN)
    if far_plane is not None:
        cfg.model.nerf.far_plane = far_plane
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.data.train_init_eff_batch_size = active
    cfg.model.pixel_bandwidth.it_sample_size = it_sample_size
    pe = cfg.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12
    cfg.model.nerf.ngp.mlp_base.n_neurons = 16
    cfg.model.nerf.ngp.mlp_head.n_neurons = 16
    cfg.model.nerf.occ_grid.resolution = 16
    return cfg


# (S, capacity, active events, sample budget): the budget holds every
# ray's samples
EDS_CASES = {4: (32, 24, 1 << 18), 30: (8, 4, 1 << 19)}
# The parity step marches to 3 instead of 13: past ~600 samples a ray
# (far 13 here), the JAX composite's float32 weight sums err by up to
# 6.4e-5 in opacity against a float64 evaluation, the port's by 1.2e-6
# (tests/test_torch_renderer.py names it), which moves the JAX step's
# loss by 1.2e-5 and its density gradients by 5e-3 of their largest entry;
# at far 13 the port's step is held to a float64 composite instead
PARITY_FAR_PLANE = 3.0


@pytest.fixture(scope="module")
def eds_jax(dataset):
    """The JAX EDS steps, compiled once for the module."""
    return {s: _jax_step(eds_config(dataset, s, case[1], PARITY_FAR_PLANE),
                         dataset, *case)
            for s, case in EDS_CASES.items()}


@pytest.mark.parametrize("it_sample_size", sorted(EDS_CASES))
def test_eds_step_matches_jax_on_its_sample_set(dataset, eds_jax,
                                                monkeypatch, it_sample_size):
    """One EDS step (S = 4 and 30; far plane 3, see PARITY_FAR_PLANE)
    against the JAX step, the port rendering the JAX step's sample set (as
    the flagship's filter-on test does): marched samples and loss within
    1e-6, the loss terms within 1e-5, every gradient (the six trainable
    filter parameters' too) within 2e-4 of its largest entry, the
    filter-on tolerances of the flagship's step."""
    j = eds_jax[it_sample_size]
    sc = j["sc"]
    assert sc.pixel_bandwidth_enabled and sc.it_sample_size == it_sample_size
    rc = j["cfg"].model.nerf
    assert (rc.contraction_type, rc.cone_angle) == ("sphere", 0.004)
    _hand_jax_samples_to_port(monkeypatch, j, dataset)
    metrics, got = _assert_port_step_matches(
        j, dataset, samples_rtol=1e-6, grad_atol=2e-4, pb_grad_atol=2e-4)
    assert float(metrics["loss"].detach()) == pytest.approx(
        float(j["loss"]), rel=1e-6)
    assert float(metrics["mean_valid_rate"]) > 0.5
    for name in ("tau_mil_it_eff_prod", "A_amp_inv", "A_loop_inv", "tau_out",
                 "tau_sf", "tau_diff"):
        assert float(got[f"pixel_bandwidth.{name}_raw"].grad.abs()) > 0, name


def _composite_float64(sigma, rgb, samples, n_rays, rc, render_bkgd=None):
    """The composite in float64, ray by ray over the march's ray ids (the
    samples of a ray in march order): the reference the port's composite
    is held to on the EDS config's long rays."""
    sigma, rgb = sigma.double(), rgb.double()
    dt, t_mid = samples.dt.double(), samples.t_mid.double()
    colors, opacities, depths, n_live = [], [], [], 0
    for r in range(n_rays):
        idx = torch.nonzero(samples.ray_idx == r)[:, 0]
        sdt = torch.clamp(sigma[idx] * dt[idx], max=25.0)
        alpha = 1.0 - torch.exp(-sdt)
        if rc.alpha_thre > 0:
            keep = alpha >= rc.alpha_thre
            sdt, alpha = sdt * keep, alpha * keep
        trans = torch.exp(-(torch.cumsum(sdt, 0) - sdt))
        live = trans > rc.early_stop_eps
        weights = trans * alpha * live
        colors.append((weights[:, None] * rgb[idx]).sum(0))
        opacities.append(weights.sum())
        depths.append((weights * t_mid[idx]).sum())
        n_live += int(live.sum())
    colors, opacities = torch.stack(colors), torch.stack(opacities)
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities[:, None])
    return (colors.float(), opacities.float(), torch.stack(depths).float(),
            torch.tensor(n_live))


@pytest.mark.parametrize("it_sample_size,active", [(4, 8), (30, 2)])
def test_eds_step_at_far_13_matches_a_float64_composite(
        dataset, tmp_path, monkeypatch, it_sample_size, active):
    """The EDS step at the config's own far plane 13 (~600 samples a ray,
    where the JAX step is not a reference: see PARITY_FAR_PLANE) against
    the same step on the same sample set with the composite evaluated in
    float64 and rounded to float32 once. The port's float32 weight sums
    over a ray's ~600 samples err by some ulp, which the log-intensity
    differences and the filter amplify; the JAX step's density gradients
    differ from the port's by up to 5e-3 of their largest entry there.
    Tolerances: loss within 1e-5; every gradient within 1e-3 of its
    largest entry, the six filter gradients within 1e-3 of the largest
    of them."""
    cfg = ConfigDict.from_dict(eds_config(dataset, it_sample_size,
                                          active).to_dict())
    assert cfg.model.nerf.far_plane == 13.0
    trainer = Trainer(cfg, str(tmp_path), batch_capacity=active,
                      sample_budget=1 << 18, device="cpu")
    trainer.update_occupancy(0)  # the warmup update of the first step
    batch = trainer._to_device(trainer.batcher.next_batch(active))
    draws = tstep.draw_step(trainer.bundle.static_config, active,
                            trainer.occ_state, trainer.generator, "cpu")
    named = [(n, p) for n, p in trainer.params.named_parameters()
             if p.requires_grad]

    def step():
        for _, p in named:
            p.grad = None
        loss, metrics = tstep.compute_loss(
            trainer.params, trainer.bundle.consts, trainer.occ_state, batch,
            draws, trainer.bundle.static_config, trainer.bundle.loss_config)
        loss.backward()
        return float(loss.detach()), metrics, {
            n: p.grad.clone() for n, p in named if p.grad is not None}

    loss, metrics, grads = step()
    assert float(metrics["mean_num_samples_per_ray"]) > 500
    assert float(metrics["ray_truncation_rate"]) == 0.0
    monkeypatch.setattr(trenderer, "composite", _composite_float64)
    want_loss, want_metrics, want = step()
    assert float(want_metrics["mean_num_samples_per_ray"]) == float(
        metrics["mean_num_samples_per_ray"])
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert set(grads) == set(want)
    filter_grads = {f"pixel_bandwidth.{n}_raw" for n in (
        "tau_mil_it_eff_prod", "A_amp_inv", "A_loop_inv", "tau_out",
        "tau_sf", "tau_diff")}
    assert filter_grads <= set(grads)
    filter_max = max(float(want[n].abs()) for n in filter_grads)
    for name, g in want.items():
        scale = filter_max if name in filter_grads else float(g.abs().max())
        err = float((grads[name] - g).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)


def _with_changes(values, changes):
    """A deep copy of nested `values` with dotted-key `changes` set."""
    out = copy.deepcopy(values)
    for key, value in changes.items():
        *parents, leaf = key.split(".")
        node = out
        for part in parents:
            node = node[part]
        node[leaf] = value
    return out


def test_chip_smoke_eds_config_is_the_yaml_with_its_listed_cuts():
    """Phase 7's configs (read with the port's YAML reader; the card
    machine has no PyYAML) equal configs/train/07_ziggy_and_fuzz_hdr.yaml
    and configs/test/07_ziggy_and_fuzz_hdr.yaml as PyYAML reads them, but
    for the cuts the phase prints on its `reduced` line."""
    import yaml

    assert (chip_smoke.EDS_TRAIN_CONFIG, chip_smoke.EDS_TEST_CONFIG) \
        == (EDS_TRAIN, EDS_TEST)
    with open(EDS_TRAIN) as f:
        train = yaml.safe_load(f)
    with open(EDS_TEST) as f:
        test = yaml.safe_load(f)
    cfg = chip_smoke.eds_config("/data/eds").to_dict()
    cuts = dict(chip_smoke.EDS_REDUCED, **{"data.dataset_directory":
                                           "/data/eds"})
    assert cfg == _with_changes(train, cuts)
    assert set(cuts) == {"data.dataset_directory", "trainer.max_epochs",
                         "trainer.limit_train_batches", "seed",
                         "trainer.ema_decay"}
    tcfg = chip_smoke.eds_config("/data/eds", test=True,
                                 checkpoint="ckpt").to_dict()
    assert tcfg == _with_changes(test, {
        "data.dataset_directory": "/data/eds", "seed": 0,
        "model.checkpoint_filepath": "ckpt"})


def test_chip_smoke_eds_step_harness_runs_on_cpu(tmp_path):
    """chip_smoke.py's card-vs-CPU EDS step, with the CPU standing in for
    the card: a non-degenerate step through the undistorted events, and
    every gradient compared, the six trainable filter parameters'
    included."""
    rows = chip_smoke.eds_step_card_vs_cpu(torch, str(tmp_path),
                                           device="cpu")
    names = {name for name, _, _ in rows}
    assert {"loss", "samples per ray", "grad pixel_bandwidth.tau_sf_raw",
            "grad nerf.field.table"} <= names
    assert all(err == 0.0 for _, err, _ in rows)  # the same device
