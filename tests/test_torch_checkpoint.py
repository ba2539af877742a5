"""The rest of the port's trainer on the CPU: the evaluation EMA (against
the JAX package's formula), gradient accumulation in the loop (equal
micro-batches per window, the occupancy schedule of optimizer steps),
checkpoints (bit-for-bit save and resume, the monitored top-k pruning,
the monitor scores across a resume, selective restore by component), each
mirroring the JAX package's tests (tests/test_trainer_semantics.py,
tests/test_resume.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu_torch.data import synthetic
from deblur_e_nerf_tpu_torch.training import checkpoint as tcheckpoint
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils.config import load_config

CAPACITY, BUDGET = 32, 1 << 14


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
    root = tmp_path_factory.mktemp("torch_ckpt_ds")
    synthetic.make_dataset(str(root), img_height=16, img_width=16,
                           num_poses=21)
    return root


def tiny_config(root, filter_on=False):
    """configs/train/synthetic.yaml at test size, as the JAX package's
    resume tests cut it: 4 levels of 2^10 rows, a 16^3 grid with a
    2-step warmup, 1 epoch of 2 micro-steps."""
    cfg = load_config("configs/train/synthetic.yaml")
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.data.train_init_eff_batch_size = 24
    cfg.model.pixel_bandwidth.enable = filter_on
    cfg.model.pixel_bandwidth.it_sample_size = 4
    pe = cfg.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 4, 4, 2.0
    pe.log2_hashmap_size = 10
    cfg.model.nerf.ngp.mlp_base.n_neurons = 16
    cfg.model.nerf.ngp.mlp_head.n_neurons = 16
    cfg.model.nerf.occ_grid.resolution = 16
    cfg.model.nerf.occ_grid.warmup_steps = 2
    cfg.trainer.max_epochs = 1
    cfg.trainer.limit_train_batches = 2
    return cfg


def _trainer(cfg, log_dir):
    # S = 4 lifetime samples with the filter on: a budget 8 x larger
    filter_on = bool(cfg.model.pixel_bandwidth.enable)
    return Trainer(cfg, str(log_dir), batch_capacity=CAPACITY,
                   sample_budget=BUDGET * (8 if filter_on else 1),
                   device="cpu")


def test_ema_matches_jax_formula_over_five_micro_steps(dataset, tmp_path):
    """ema = ema * d + p * (1 - d) after every micro-step, seeded from the
    parameters: bit for bit with the JAX trainer's formula evaluated in
    that order of operations (numpy float32), over 5 micro-steps. XLA's
    CPU build of the JAX trainer's `_ema_fn` fuses the two products into
    one multiply-add, which skips the rounding of ema * d: the port is
    within one ulp of ema * d plus one ulp of the result of it."""
    cfg = tiny_config(dataset)
    cfg.trainer.ema_decay = 0.9
    cfg.trainer.limit_train_batches = 5
    trainer = _trainer(cfg, tmp_path)
    d = 0.9
    ema = {n: p.detach().numpy().copy()
           for n, p in trainer.params.named_parameters()}
    xla = jax.jit(lambda e, q: e * d + q * (1.0 - d))
    for _ in range(5):
        trainer.train_step()
        live = {n: p.detach().numpy()
                for n, p in trainer.params.named_parameters()}
        got = {n: p.numpy() for n, p in
               trainer.ema_params.named_parameters()}
        for n, e in ema.items():
            q = live[n]
            want = e * e.dtype.type(d) + q * q.dtype.type(1.0 - d)
            np.testing.assert_array_equal(got[n], want, err_msg=n)
            fused = np.asarray(xla(jnp.asarray(e), jnp.asarray(q)))
            assert np.all(np.abs(got[n] - fused)
                          <= np.spacing(np.abs(e * e.dtype.type(d)))
                          + np.spacing(np.abs(fused))), n
            ema[n] = got[n].copy()
    table = trainer.ema_params.nerf.field.table
    assert not torch.equal(table, trainer.params.nerf.field.table)


def test_accumulation_window_constant_batch_and_warmup_occupancy(
        dataset, tmp_path):
    """Accumulation 2 over 12 micro-steps: the micro-batches of each
    window have equal sizes, and the occupancy grid updates at optimizer
    steps 0 and 1 (the warmup) and then every n = 4-th (step 4), each at
    a window start; the optimizer updates once per window."""
    cfg = tiny_config(dataset)
    cfg.trainer.limit_train_batches = 12
    cfg.trainer.accumulate_grad_batches = 2
    cfg.model.nerf.occ_grid.n = 4
    trainer = _trainer(cfg, tmp_path)
    active_log, occ_log = [], []
    next_batch = trainer.batcher.next_batch
    update = trainer.update_occupancy

    def logging_next(active):
        active_log.append(int(active))
        return next_batch(active)

    def logging_occ(step=None):
        occ_log.append((int(step), trainer.global_step))
        return update(step)

    trainer.batcher.next_batch = logging_next
    trainer.update_occupancy = logging_occ
    trainer.train()
    assert len(active_log) == 12
    for w in range(0, 12, 2):
        assert active_log[w] == active_log[w + 1], active_log
    assert len(set(active_log)) > 1  # the controller did move
    assert occ_log == [(0, 0), (1, 2), (4, 8)], occ_log
    assert int(trainer.optimizer.count) == 6
    assert int(trainer.optimizer.mini_step) == 0


def test_prune_checkpoints_monitor_semantics(tmp_path):
    """With `monitor` set, the save_top_k best scored checkpoints (mode
    min/max) plus the latest epoch stay, and best_checkpoint follows;
    without one, the most recent stay; k <= 0 keeps all."""
    def bare(log_dir):
        tr = Trainer.__new__(Trainer)
        tr.log_dir = str(log_dir)
        tr._ckpt_scores = {}
        tr.best_checkpoint = None
        (log_dir / "checkpoints").mkdir(parents=True)
        return tr

    def kept(log_dir):
        return sorted(d for d in os.listdir(log_dir / "checkpoints")
                      if d.startswith("epoch_"))

    tr = bare(tmp_path / "a")
    for e, score in enumerate([0.5, 0.2, 0.9, 0.4]):
        (tmp_path / "a" / "checkpoints" / f"epoch_{e:04d}").write_bytes(b"")
        tr._ckpt_scores[f"epoch_{e:04d}"] = score
    tr._prune_checkpoints(1, monitor="val/loss", mode="min")
    assert kept(tmp_path / "a") == ["epoch_0001", "epoch_0003"]
    assert tr.best_checkpoint.endswith("epoch_0001")
    assert set(tr._ckpt_scores) == {"epoch_0001", "epoch_0003"}

    tr = bare(tmp_path / "b")
    for e, score in enumerate([15.0, 22.0, 18.0]):
        (tmp_path / "b" / "checkpoints" / f"epoch_{e:04d}").write_bytes(b"")
        tr._ckpt_scores[f"epoch_{e:04d}"] = score
    tr._prune_checkpoints(1, monitor="val/psnr", mode="max")
    assert kept(tmp_path / "b") == ["epoch_0001", "epoch_0002"]
    assert tr.best_checkpoint.endswith("epoch_0001")

    tr = bare(tmp_path / "c")
    for e in range(4):
        (tmp_path / "c" / "checkpoints" / f"epoch_{e:04d}").write_bytes(b"")
    tr._prune_checkpoints(-1)
    assert len(kept(tmp_path / "c")) == 4
    tr._prune_checkpoints(2)
    assert kept(tmp_path / "c") == ["epoch_0002", "epoch_0003"]


def _state(trainer):
    """Every tensor a resume must bring back, by name."""
    opt = trainer.optimizer
    out = {f"param {n}": p.detach() for n, p in
           trainer.params.named_parameters()}
    for n, p in opt.named_params():
        out[f"m {n}"], out[f"v {n}"] = opt.state[p]
        if p in opt.acc:
            out[f"acc {n}"] = opt.acc[p]
    if trainer.ema_params is not None:
        out.update({f"ema {n}": p for n, p in
                    trainer.ema_params.named_parameters()})
    out.update(count=opt.count, mini_step=opt.mini_step,
               occs=trainer.occ_state.occs, binary=trainer.occ_state.binary,
               global_step=torch.tensor(trainer.global_step))
    return {k: v.clone() for k, v in out.items()}


def test_resume_restores_the_saved_state_bit_for_bit(dataset, tmp_path):
    """An epoch of 3 micro-steps with accumulation 2 (so the running mean
    holds one micro-step at the save), the filter on and an EMA: a fresh
    trainer resumed from epoch_0000 holds the same parameters, moments,
    running mean, counts, occupancy grid, EMA and global step bit for bit,
    and train(start_epoch=...) continues from the next epoch (none left:
    a no-op; one more: 3 more micro-steps). The generator and the batcher
    restart from `seed`, as the JAX package restarts its PRNG key, so the
    resumed run does not repeat the original's draws."""
    cfg = tiny_config(dataset, filter_on=True)
    cfg.trainer.limit_train_batches = 3
    cfg.trainer.accumulate_grad_batches = 2
    cfg.trainer.ema_decay = 0.9
    tr = _trainer(cfg, tmp_path / "a")
    tr.train()
    ckpt = tmp_path / "a" / "checkpoints" / "epoch_0000"
    assert ckpt.is_file()
    assert (tmp_path / "a" / "checkpoints" / "config.yaml").is_file()
    want = _state(tr)
    assert int(want["mini_step"]) == 1 and int(want["count"]) == 1
    assert float(want["acc nerf.field.table"].abs().max()) > 0

    tr2 = _trainer(cfg, tmp_path / "b")
    last_epoch = tr2.resume(str(ckpt))
    assert last_epoch == 0
    got = _state(tr2)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        assert torch.equal(got[name], value), name
    tr2.train(start_epoch=last_epoch + 1)  # no epochs left
    assert tr2.global_step == 3
    tr2.max_epochs = 2
    tr2.train(start_epoch=last_epoch + 1)
    assert tr2.global_step == 6
    assert int(tr2.optimizer.count) == 3
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == [
        "config.yaml", "epoch_0001"]


def test_resume_without_ema_in_the_checkpoint_reseeds_it(dataset,
                                                         tmp_path):
    cfg = tiny_config(dataset)
    tr = _trainer(cfg, tmp_path / "a")
    tr.train()
    cfg.trainer.ema_decay = 0.99
    tr2 = _trainer(cfg, tmp_path / "b")
    tr2.resume(str(tmp_path / "a" / "checkpoints" / "epoch_0000"))
    for (n, e), p in zip(tr2.ema_params.named_parameters(),
                         tr.params.parameters()):
        assert torch.equal(e, p.detach()), n


def test_monitor_scores_survive_resume(dataset, tmp_path):
    """The monitored scores come back from monitor_scores.json on resume
    (the checkpoints that still exist), so pruning after a resume keeps the
    pre-resume best and the latest."""
    cfg = tiny_config(dataset)
    cfg.checkpoint = {"monitor": "val/psnr", "mode": "max",
                      "save_top_k": 1}
    log = tmp_path / "log"
    tr = _trainer(cfg, log)
    tr.train()  # epoch_0000, unscored (no evaluation ran)
    ckpt_dir = log / "checkpoints"
    for name, score in [("epoch_0000", 14.5), ("epoch_0001", 16.2),
                        ("epoch_0002", 13.1)]:
        if not (ckpt_dir / name).exists():
            (ckpt_dir / name).write_bytes(b"")
        tr._ckpt_scores[name] = score
    tr._persist_ckpt_scores()

    tr2 = _trainer(cfg, log)
    assert tr2._ckpt_scores == {}
    tr2.resume(str(ckpt_dir / "epoch_0000"))
    assert tr2._ckpt_scores == {"epoch_0000": 14.5, "epoch_0001": 16.2,
                                "epoch_0002": 13.1}
    assert tr2.best_checkpoint == str(ckpt_dir / "epoch_0001")
    tr2._prune_checkpoints(1, monitor="val/psnr", mode="max")
    assert sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("epoch_")) == ["epoch_0001", "epoch_0002"]
    tr3 = _trainer(cfg, log)
    tr3._load_ckpt_scores()
    assert set(tr3._ckpt_scores) == {"epoch_0001", "epoch_0002"}


def test_monitored_score_of_the_last_evaluation_is_recorded(dataset,
                                                            tmp_path):
    cfg = tiny_config(dataset)
    cfg.checkpoint = {"monitor": "val/psnr", "mode": "max",
                      "save_top_k": 1}
    tr = _trainer(cfg, tmp_path)
    tr._last_eval["val/psnr"] = 21.5
    tr.train()
    assert tr._ckpt_scores == {"epoch_0000": 21.5}
    assert tr.best_checkpoint == str(tmp_path / "checkpoints" /
                                     "epoch_0000")
    assert (tmp_path / "checkpoints" / "monitor_scores.json").is_file()


@pytest.fixture(scope="module")
def trained_checkpoint(dataset, tmp_path_factory):
    """A filter-on checkpoint whose every component differs from a fresh
    build, and the trainer that wrote it."""
    log = tmp_path_factory.mktemp("ckpt_src")
    tr = _trainer(tiny_config(dataset, filter_on=True), log)
    tr.train()
    with torch.no_grad():
        for p in tr.params.parameters():
            p.add_(0.125)
    tr.occ_state = tr.occ_state._replace(
        occs=tr.occ_state.occs + 0.5,
        binary=~tr.occ_state.binary)
    return tr.save_checkpoint(7), tr


@pytest.mark.parametrize("component", ["contrast_threshold",
                                       "refractory_period",
                                       "pixel_bandwidth", "nerf"])
def test_selective_restore_honours_each_flag(dataset, tmp_path,
                                             trained_checkpoint, component):
    """model.checkpoint_filepath with one component's load_state_dict set:
    that component comes back from the checkpoint, the others stay as
    built; the occupancy grid comes back exactly with `nerf`."""
    path, source = trained_checkpoint
    cfg = tiny_config(dataset, filter_on=True)
    fresh = _trainer(cfg, tmp_path / "fresh")
    cfg.model.checkpoint_filepath = path
    cfg.model[component].load_state_dict = True
    tr = _trainer(cfg, tmp_path / "restored")
    for name, child in tr.params.named_children():
        want = getattr(source.params if name == component else fresh.params,
                       name)
        for (n, p), q in zip(child.named_parameters(), want.parameters()):
            assert torch.equal(p, q), f"{name}.{n}"
    occ_src = source.occ_state if component == "nerf" else fresh.occ_state
    assert torch.equal(tr.occ_state.occs, occ_src.occs)
    assert torch.equal(tr.occ_state.binary, occ_src.binary)


def test_selective_restore_of_a_missing_component_raises(dataset, tmp_path,
                                                         trained_checkpoint):
    path, source = trained_checkpoint
    payload = tcheckpoint.restore(path, "cpu")
    del payload["params"]["pixel_bandwidth"]
    tcheckpoint.save(str(tmp_path / "no_filter"), payload)
    cfg = tiny_config(dataset, filter_on=True)
    cfg.model.checkpoint_filepath = str(tmp_path / "no_filter")
    cfg.model.pixel_bandwidth.load_state_dict = True
    with pytest.raises(KeyError, match="pixel_bandwidth"):
        _trainer(cfg, tmp_path / "log")
    # without the flag the same checkpoint serves the other components
    cfg.model.pixel_bandwidth.load_state_dict = False
    cfg.model.nerf.load_state_dict = True
    tr = _trainer(cfg, tmp_path / "log2")
    assert torch.equal(tr.params.nerf.field.table,
                       source.params.nerf.field.table)


def test_profile_steps_write_a_trace_of_the_window(dataset, tmp_path):
    """trainer.profile_steps [1, 3]: micro-steps 1 and 2 traced by
    torch.profiler into <log_dir>/profile (a chrome trace and the
    operator table), and the run goes on past the window."""
    cfg = tiny_config(dataset)
    cfg.trainer.limit_train_batches = 4
    cfg.trainer.profile_steps = [1, 3]
    tr = _trainer(cfg, tmp_path)
    tr.train()
    assert tr.global_step == 4 and tr._profiler is None
    files = sorted(os.listdir(tmp_path / "profile"))
    assert files == ["ops_1_3.txt", "trace_1_3.json"]
    assert "aten::" in (tmp_path / "profile" / "ops_1_3.txt").read_text()
