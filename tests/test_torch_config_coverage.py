"""Every train and test config of the repo builds a port Trainer and reads
without PyYAML, and a JAX checkpoint, turned into the port's by
`convert.checkpoint_from_jax`, evaluates in the port as in the JAX
package."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu.training import checkpoint as jcheckpoint
from deblur_e_nerf_tpu.training.trainer import Trainer as JTrainer
from deblur_e_nerf_tpu_torch import convert
from deblur_e_nerf_tpu_torch.data import synthetic
from deblur_e_nerf_tpu_torch.training import checkpoint as tcheckpoint
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils import config as config_lib
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict, load_config
from test_torch_real_data import COMPONENTS, distort_calibration, eds_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, where torch's spinning thread pool makes these small
    ops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eds_eval_ds")
    jsynthetic.make_dataset(str(root), img_height=32, img_width=32,
                            num_poses=21, num_views=2)
    distort_calibration(root)
    return root


@pytest.fixture(scope="module")
def lpips_alex_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "alex.pt"
    return chip_smoke.write_lpips_stub(torch, str(path), "alex")


def test_jax_checkpoint_converts_and_evaluates_like_jax(
        dataset, tmp_path, lpips_alex_weights):
    """A JAX Trainer (accumulation 2, ema_decay 0.9) trains 2 micro-steps
    and saves through orbax; `convert.checkpoint_from_jax` turns the
    restored tree into the port's checkpoint, which the port evaluates
    through model.checkpoint_filepath (every component's load_state_dict
    set). Its restored parameters and occupancy grid equal the JAX
    checkpoint's, and every metric equals JAX Trainer.evaluate on the same
    checkpoint (rtol 1e-4, PSNR within 1e-3 dB). A converted checkpoint
    has no optimizer moments (the optax state is not converted), so
    resuming it raises."""
    cfg = eds_config(dataset)
    cfg.model.nerf.test_chunk_size = 256
    cfg.trainer.max_epochs = 1
    cfg.trainer.limit_train_batches = 2
    cfg.trainer.accumulate_grad_batches = 2
    cfg.trainer.ema_decay = 0.9
    cfg.metric.lpips_weights_path = lpips_alex_weights
    jtr = JTrainer(cfg, str(tmp_path / "jax"), batch_capacity=32,
                   sample_budget=1 << 17)
    jtr.train()
    jpath = str(tmp_path / "jax" / "checkpoints" / "epoch_0000")
    payload = jax.tree_util.tree_map(np.asarray, jcheckpoint.restore(jpath))
    assert "ema_params" in payload
    converted = convert.checkpoint_from_jax(payload)
    assert converted["opt_state"] is None
    assert converted["global_step"] == converted["step"] == 2
    tpath = str(tmp_path / "port.ckpt")
    tcheckpoint.save(tpath, converted)

    eval_cfg = ConfigDict.from_dict(cfg.to_dict())
    for component in COMPONENTS:
        eval_cfg.model[component].load_state_dict = True
    eval_cfg.model.checkpoint_filepath = jpath
    jeval = JTrainer(eval_cfg, str(tmp_path / "jax_eval"), batch_capacity=32,
                     sample_budget=1 << 17)
    eval_cfg.model.checkpoint_filepath = tpath
    teval = Trainer(eval_cfg, str(tmp_path / "port_eval"), batch_capacity=32,
                    sample_budget=1 << 17, device="cpu")
    want = convert.params_from_jax(payload["params"])
    for name, p in teval.params.named_parameters():
        assert torch.equal(p.detach(), want[name].to(p.dtype)), name
    assert np.array_equal(teval.occ_state.occs.numpy(),
                          payload["occ_state"]["occs"])
    assert np.array_equal(teval.occ_state.binary.numpy(),
                          payload["occ_state"]["binary"])
    assert 0 < float(teval.occ_state.binary.float().mean()) < 1

    want_m = jeval.evaluate("val")
    got_m = teval.evaluate("val")
    assert set(got_m) == set(want_m) == {"l1", "psnr", "ssim", "lpips"}
    for name in want_m:
        assert np.isfinite(got_m[name]), name
        assert got_m[name] == pytest.approx(want_m[name], rel=1e-4), name
    assert abs(got_m["psnr"] - want_m["psnr"]) <= 1e-3

    with pytest.raises(ValueError, match="no optimizer moments"):
        Trainer(cfg, str(tmp_path / "resume"), batch_capacity=32,
                sample_budget=1 << 17, device="cpu").resume(tpath)


@pytest.fixture(scope="module")
def tiny_views_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cover_ds")
    synthetic.make_dataset(str(root), img_height=8, img_width=8,
                           num_poses=11, num_views=1, write_views=True)
    return root


TRAIN_CONFIGS = sorted(glob.glob("configs/train/*.yaml"))
TEST_CONFIGS = sorted(glob.glob("configs/test/*.yaml"))


def cut(cfg, root):
    """A repo config at coverage size: 2^10 rows a level, a 16^3 grid,
    eval chunks of 64 rays, a tiny dataset, and a block budget set in the
    config (4,194,304 on the r5fix pair, sized for its full batch) cut to
    2^12 like the sample budget; every other setting as written."""
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.model.nerf.ngp.pos_encoding.log2_hashmap_size = 10
    cfg.model.nerf.occ_grid.resolution = 16
    cfg.model.nerf.test_chunk_size = 64
    if cfg.model.nerf.get("block_budget"):
        cfg.model.nerf.block_budget = 1 << 12
    cfg.metric.lpips_weights_path = None
    return cfg


def _build(cfg, log_dir):
    return Trainer(cfg, str(log_dir), batch_capacity=16,
                   sample_budget=1 << 12, device="cpu")


def test_the_repo_has_27_train_and_4_test_configs():
    assert len(TRAIN_CONFIGS) == 27 and len(TEST_CONFIGS) == 4


@pytest.mark.parametrize("path", TRAIN_CONFIGS + TEST_CONFIGS,
                         ids=os.path.basename)
def test_every_config_builds_a_port_trainer(tiny_views_dataset, tmp_path,
                                            path):
    """Each train and test config of the repo builds a port Trainer at cut
    widths and takes a train step with a finite loss; a test config loads
    a tiny port checkpoint of its own model through
    model.checkpoint_filepath. The 2 configs that set
    model.nerf.occlusion_prepass_div (the r5fix pair) configure the
    prepass and report the step's live demand against its buffer (a
    non-zero prepass_overflow_rate; a fresh trainer's first step runs
    without the prepass, ROADMAP Queue C 9) and, as they also set
    model.nerf.eval_occlusion_prepass_div, evaluate with it (a finite
    PSNR)."""
    cfg = cut(load_config(path), tiny_views_dataset)
    ckpt = cfg.model.get("checkpoint_filepath")
    if ckpt:
        source = ConfigDict.from_dict(cfg.to_dict())
        source.model.checkpoint_filepath = None
        cfg.model.checkpoint_filepath = _build(
            source, tmp_path / "source").save_checkpoint(0)
    trainer = _build(cfg, tmp_path / "log")
    if ckpt:
        assert any(cfg.model[c].get("load_state_dict") for c in COMPONENTS)
    metrics = trainer.train_step()
    assert np.isfinite(float(metrics["loss"])), path
    prepass_div = cfg.model.nerf.get("occlusion_prepass_div")
    assert trainer.params.nerf.render_config.prepass_div \
        == int(prepass_div or 0)
    assert (float(metrics["prepass_overflow_rate"]) > 0) == bool(prepass_div)
    assert float(metrics["prepass_ran"]) == 0.0
    eval_div = cfg.model.nerf.get("eval_occlusion_prepass_div")
    if eval_div:
        _, render_image = trainer.build_evaluator("val")
        assert render_image.render_config.prepass_div == int(eval_div)
    if ckpt or eval_div or "07_ziggy" in path:
        metric = trainer.evaluate("val", max_images=1)
        assert np.isfinite(metric["psnr"])


@pytest.mark.parametrize("mesh_devices, num_nodes, device, error", [
    (3, 1, "cpu", "batch_capacity 16 must divide by mesh_devices 3"),
    (4, 3, "cpu", "num_nodes 3 does not divide mesh_devices 4"),
    (2, 1, "cuda", "mesh_devices 2: no CUDA device is visible"),
    (1, 1, "cpu", None),
])
def test_data_parallel_keys_are_checked(tiny_views_dataset, tmp_path,
                                        mesh_devices, num_nodes, device,
                                        error):
    """trainer.mesh_devices and trainer.num_nodes (data parallelism,
    parallel/): a capacity that does not divide over the ranks, a
    num_nodes that does not divide them, and a CUDA mesh without a card
    raise before anything is built; mesh 1, as every config of the repo
    sets, builds a single-process trainer as before."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("the no-card check needs a machine without CUDA")
    cfg = cut(load_config("configs/train/synthetic.yaml"), tiny_views_dataset)
    cfg.trainer.mesh_devices = mesh_devices
    cfg.trainer.num_nodes = num_nodes
    if error is None:
        trainer = Trainer(cfg, str(tmp_path / "one"), batch_capacity=16,
                          sample_budget=1 << 12, device=device)
        assert trainer.mesh is None and trainer.world == 1
        return
    with pytest.raises(ValueError, match=error):
        Trainer(cfg, str(tmp_path / "mesh"), batch_capacity=16,
                sample_budget=1 << 12, device=device)
    assert not (tmp_path / "mesh").exists()


@pytest.mark.parametrize("path", TRAIN_CONFIGS + TEST_CONFIGS,
                         ids=os.path.basename)
def test_yaml_reader_without_pyyaml_matches_pyyaml(path):
    """The port's own YAML reader (`load_config` reads with it; the GPU
    machine has no PyYAML) reads every config of the repo as PyYAML does,
    and reads back what `save_config` writes."""
    import yaml

    with open(path) as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert config_lib.yaml_load(text) == want
    assert load_config(path).to_dict() == want
    assert config_lib.yaml_load(config_lib.yaml_text(want)) == want


def test_yaml_text_reads_back_through_pyyaml():
    """The emitter's nested lists, lists of mappings, empty containers,
    nulls, booleans, exact floats and strings with quotes, brackets,
    colons and comment marks, as PyYAML and the port's reader read them;
    a top-level list too."""
    import yaml

    value = {"a": [1, "x, y"], "b": [], "c": {"d": [[1], [2, None]]},
             "e": [{"f": 1, "g": [2.5e-300]}], "h": {}, "i": True,
             "j": "on", "k": 0.1 + 0.2, "l": None,
             "m": ["it's", 'say "hi" # [x: {y}', "back\\slash", "é"],
             "n: o": {"p # q": "r: s"}}
    for v in (value, [value, {}, [1, "t"]]):
        text = config_lib.yaml_text(v)
        assert yaml.safe_load(text) == v
        assert config_lib.yaml_load(text) == v
