"""The port's trainer with evaluation on the CPU: per-epoch validation at the
configured cadence through `train(on_epoch_end=...)`, both eval targets
together, the `train`, `val` and `test` stages of the command line (the
metrics file read back by PyYAML; `train` resuming a checkpoint, `test`
evaluating one), and what raised until it was ported (checkpoints,
resume, the EMA, the eval occlusion prepass) running."""

import json
import math

import pytest
import torch
import yaml

import chip_smoke
from deblur_e_nerf_tpu_torch.__main__ import main
from deblur_e_nerf_tpu_torch.data import synthetic
from deblur_e_nerf_tpu_torch.training import trainer as trainer_lib
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils import config as config_lib
from deblur_e_nerf_tpu_torch.utils.config import load_config, save_config

CAPACITY, BUDGET = 32, 1 << 15


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
    root = tmp_path_factory.mktemp("torch_trainer_eval_ds")
    synthetic.make_dataset(str(root), img_height=12, img_width=16,
                           num_poses=21, num_views=2, write_views=True)
    return root


def small_config(root):
    cfg = load_config("configs/train/synthetic.yaml")
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.data.train_init_eff_batch_size = 24
    cfg.model.pixel_bandwidth.enable = False
    pe = cfg.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12
    cfg.model.nerf.ngp.mlp_base.n_neurons = 16
    cfg.model.nerf.ngp.mlp_head.n_neurons = 16
    cfg.model.nerf.occ_grid.resolution = 32
    cfg.model.nerf.test_chunk_size = 64
    cfg.trainer.limit_train_batches = 2
    cfg.trainer.max_epochs = 3
    cfg.trainer.log_every_n_steps = 1
    return cfg


def test_train_validates_at_the_epoch_cadence(dataset, tmp_path):
    """`train(on_epoch_end=...)` calls the hook once per epoch; the hook
    of the command line evaluates every check_val_every_n_epoch-th epoch
    (here 2 of 3: epoch 1 only) and the scalar log holds the eval
    metrics at that step."""
    cfg = small_config(dataset)
    trainer = Trainer(cfg, str(tmp_path), batch_capacity=CAPACITY,
                      sample_budget=BUDGET, device="cpu")
    calls = []

    def on_epoch_end(tr, epoch):
        calls.append((epoch, tr.global_step))
        if (epoch + 1) % 2 == 0:
            metric = tr.evaluate("val", epoch)
            assert set(metric) == {"l1", "psnr", "ssim", "lpips"}
            assert all(math.isfinite(metric[k])
                       for k in ("l1", "psnr", "ssim"))
            assert math.isnan(metric["lpips"])  # no weights configured

    trainer.train(on_epoch_end=on_epoch_end)
    assert calls == [(0, 2), (1, 4), (2, 6)]
    logged = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    evals = [row for row in logged if "val/psnr" in row]
    assert [row["step"] for row in evals] == [4]
    assert "val/lpips" not in evals[0]  # NaN is not logged
    # the black-level correction's error trace of the eval epoch
    assert (tmp_path / "correction-errors" / "1.csv").is_file()


def test_evaluate_both_targets(dataset, tmp_path):
    """eval_target [event_view, novel_view]: the train views and the
    stage's, each with its own metric names and artifact directory."""
    cfg = small_config(dataset)
    cfg.eval_target = ["event_view", "novel_view"]
    cfg.model.eval_save_pred_intensity_img = True
    trainer = Trainer(cfg, str(tmp_path), batch_capacity=CAPACITY,
                      sample_budget=BUDGET, device="cpu")
    metric = trainer.evaluate("test", max_images=1)
    assert set(metric) == {f"{t}/{m}" for t in ("event_view", "novel_view")
                           for m in ("l1", "psnr", "ssim", "lpips")}
    for target, stage in (("event_view", "train"), ("novel_view", "test")):
        saved = list((tmp_path / target / "predictions").iterdir())
        assert len(saved) == 1 and saved[0].name.startswith(stage), saved
    cfg.eval_target = ["stereo_view"]
    with pytest.raises(NotImplementedError, match="eval_target"):
        trainer.build_evaluator()


@pytest.mark.parametrize("stage", ["val", "test"])
def test_cli_eval_stage_writes_metrics_yaml(dataset, tmp_path, stage):
    cfg = small_config(dataset)
    path = tmp_path / "cfg.yaml"
    save_config(cfg, str(path))
    log = tmp_path / "log"
    assert main([stage, str(path), "--device", "cpu", "--log-dir", str(log),
                 "--batch-capacity", str(CAPACITY), "--sample-budget",
                 str(BUDGET), "--max-eval-images", "1"]) == 0
    loaded = yaml.safe_load((log / "metrics.yaml").read_text())
    assert isinstance(loaded, list) and len(loaded) == 1
    assert set(loaded[0]) == {"l1", "psnr", "ssim", "lpips"}
    assert math.isnan(loaded[0]["lpips"]) and loaded[0]["psnr"] > 0


def test_cli_train_validates_every_epoch(dataset, tmp_path, capsys):
    cfg = small_config(dataset)
    cfg.trainer.max_epochs = 2
    cfg.trainer.check_val_every_n_epoch = 1
    path = tmp_path / "cfg.yaml"
    save_config(cfg, str(path))
    assert main(["train", str(path), "--device", "cpu", "--log-dir",
                 str(tmp_path / "log"), "--batch-capacity", str(CAPACITY),
                 "--sample-budget", str(BUDGET),
                 "--max-eval-images", "1"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0: val {" in out and "epoch 1: val {" in out


def test_metrics_yaml_reads_back_exactly():
    values = [{"psnr": 31.25, "ssim": 0.1 + 0.2, "l1": 1e-05,
               "lpips": float("nan"), "a/b": -1e300, "big": 1e16,
               "inf": float("inf"), "neg": -0.0}, {}]
    text = trainer_lib.yaml_metrics(values)
    for loaded in (yaml.safe_load(text), config_lib.yaml_load(text)):
        assert loaded[1] == {}
        for name, value in values[0].items():
            got = loaded[0][name]
            assert isinstance(got, float), name
            assert (math.isnan(got) and math.isnan(value)) \
                or got == value, name
    assert yaml.safe_load(trainer_lib.yaml_metrics([])) == []
    assert config_lib.yaml_load(trainer_lib.yaml_metrics([])) == []


def test_what_is_not_ported_raises_naming_its_roadmap_item(dataset,
                                                           tmp_path):
    """Checkpoints, resume and the evaluation EMA (which raised, naming
    ROADMAP Queue A 9, until they were ported) build and run, and so does
    the eval occlusion prepass (which raised, naming ROADMAP Queue B 6):
    evaluate("val") with eval_occlusion_prepass_div 4 renders through it
    and returns finite metrics."""
    trainer = Trainer(small_config(dataset), str(tmp_path / "a"),
                      batch_capacity=CAPACITY, sample_budget=BUDGET,
                      device="cpu")
    ckpt = trainer.save_checkpoint(0)
    for section, key, value in (
            ("model", "checkpoint_filepath", ckpt),
            ("trainer", "resume_from_checkpoint", ckpt),
            ("trainer", "ema_decay", 0.999)):
        cfg = small_config(dataset)
        cfg[section][key] = value
        built = Trainer(cfg, str(tmp_path / key), batch_capacity=CAPACITY,
                        sample_budget=BUDGET, device="cpu")
        assert (built.ema_params is not None) == (key == "ema_decay")
    assert trainer.resume(ckpt) == 0
    trainer.config.model.nerf.eval_occlusion_prepass_div = 4
    _, render_image = trainer.build_evaluator("val")
    assert render_image.render_config.prepass_div == 4
    metric = trainer.evaluate("val")
    assert set(metric) == {"l1", "psnr", "ssim", "lpips"}
    assert all(math.isfinite(metric[k]) for k in ("l1", "psnr", "ssim"))


def test_cli_train_resumes_and_test_evaluates_a_checkpoint(dataset,
                                                           tmp_path,
                                                           capsys):
    """`train` with trainer.resume_from_checkpoint starts at the epoch
    after the checkpoint's; `test` with model.checkpoint_filepath (every
    component's load_state_dict set, as configs/test/*.yaml do) writes
    metrics.yaml."""
    cfg = small_config(dataset)
    cfg.trainer.max_epochs = 1
    path = tmp_path / "cfg.yaml"
    save_config(cfg, str(path))
    args = ["--device", "cpu", "--batch-capacity", str(CAPACITY),
            "--sample-budget", str(BUDGET), "--max-eval-images", "1"]
    assert main(["train", str(path), "--log-dir", str(tmp_path / "a")]
                + args) == 0
    ckpt = tmp_path / "a" / "checkpoints" / "epoch_0000"
    assert ckpt.is_file()
    assert yaml.safe_load((ckpt.parent / "config.yaml").read_text()) \
        == cfg.to_dict()
    capsys.readouterr()
    cfg.trainer.max_epochs = 2
    cfg.trainer.resume_from_checkpoint = str(ckpt)
    save_config(cfg, str(path))
    assert main(["train", str(path), "--log-dir", str(tmp_path / "b")]
                + args) == 0
    out = capsys.readouterr().out
    assert "at epoch 1" in out
    assert "epoch 1: val {" in out and "epoch 0: val" not in out
    assert "(4 steps)" in out
    assert sorted(p.name for p in (tmp_path / "b" / "checkpoints")
                  .iterdir()) == ["config.yaml", "epoch_0001"]

    test_cfg = small_config(dataset)
    test_cfg.model.checkpoint_filepath = str(ckpt)
    for component in ("contrast_threshold", "refractory_period",
                      "pixel_bandwidth", "nerf"):
        test_cfg.model[component].load_state_dict = True
    save_config(test_cfg, str(path))
    assert main(["test", str(path), "--log-dir", str(tmp_path / "t")]
                + args) == 0
    loaded = yaml.safe_load((tmp_path / "t" / "metrics.yaml").read_text())
    assert set(loaded[0]) == {"l1", "psnr", "ssim", "lpips"}
    assert loaded[0]["psnr"] > 0


def test_chip_smoke_eval_render_harness_runs_on_cpu(tmp_path):
    """chip_smoke.py's card-vs-CPU eval render, with the CPU standing in
    for the card: a non-degenerate render (several field calls per ray
    chunk) that agrees with itself exactly."""
    rows = chip_smoke.eval_render_card_vs_cpu(torch, str(tmp_path),
                                              device="cpu")
    assert [name for name, _, _ in rows] == [
        "marched samples per pixel (pixels differing)", "image"]
    assert all(err == 0 for _, err, _ in rows)
