"""Data-parallel training step over torch.distributed ranks (counterpart
of deblur_e_nerf_tpu/parallel/data_parallel.py).

The JAX package compiles one SPMD program in which every loss mean and
metric is a global reduction by construction. Here each rank is a process
with its share of the event batch, and the step is made equal to that
global program:

- every rank runs the same `EventBatcher` stream from the same seed and
  takes its rows of the global batch (`shard_batch`), as the JAX package's
  multi-process assembly does, so no batch crosses ranks;
- every rank draws the global step draws from its generator, which stays in
  lockstep with the others', and takes its share (`shard_draws`); the
  sparsity prior's draws stay whole (replicated);
- a masked mean divides the rank's masked sum by the global count (one
  all-reduce of the step's counts, before `backward`), so the summed
  gradients are the gradients of the global mean; the replicated sparsity
  prior enters each rank's loss scaled by 1 / world, so its gradient is
  counted once;
- the gradients are summed over the ranks (bucketed over flat buffers)
  after `backward` and before `optimizer.step`, and the metrics are rebuilt
  from numerators and denominators with one all-reduce per reduction kind,
  so the optimizer's skip decision and every host decision of the trainer
  read the same global values on every rank.

Parameters, optimizer state, occupancy grid, EMA and generator are
replicated: `replicate` broadcasts them from rank 0 at the start and after
a resume, and they stay bit-identical because every rank applies the same
summed gradients (`digest` checks it). The occupancy update needs no
wrapper (the JAX package's `make_sharded_occ_update` only places it
replicated): every rank runs the trainer's own update on its replica, with
no collective.

Each rank's sample budget is K / world (and the block and superblock
budgets likewise, `shard_render_config`). Without an overflow the step
equals the single-process one; a rank whose share overflows its K / world
buffer truncates its tail events where the global buffer of the JAX
package might not (ROADMAP Queue C 1).
"""

import dataclasses

import torch
import torch.distributed as dist

from ..training import step as step_lib

# flat all-reduce buckets of at most this many bytes (a larger tensor is
# its own bucket)
BUCKET_BYTES = 25 << 20

# how each metric of `step.compute_loss` becomes global: SUM for counts,
# sums and means whose denominator was already global; a SUM then / world
# for rates over each rank's equal share of a budget; MAX for the worst
# rank's prepass demand over its own buffer (the value the trainer's
# prepass switch reads) and the path flag; MIN for the filter's smallest
# weight sum; the sparsity prior is replicated; the samples per ray and
# the sample overflow are recomputed from the global counts
SUM_METRICS = ("loss", "loss_log_intensity_diff", "loss_log_intensity_tv",
               "mean_ray_occ_rate", "ray_truncation_rate", "mean_valid_rate",
               "batch_size", "num_rays", "num_marched_samples",
               "block_overflow_rate", "superblock_overflow_rate")
RATE_METRICS = ("block_overflow_rate", "superblock_overflow_rate")
MAX_METRICS = ("prepass_overflow_rate", "prepass_ran")
MIN_METRICS = ("pb_min_abs_weight_sum",)
REPLICATED_METRICS = ("loss_density_sparsity",)
DERIVED_METRICS = ("mean_num_samples_per_ray", "sample_overflow_rate")


def shard_rows(n, rank, world):
    """Rank `rank`'s rows [rank n / world, (rank + 1) n / world)."""
    if n % world:
        raise ValueError(f"{n} rows do not divide over {world} ranks")
    size = n // world
    return slice(rank * size, (rank + 1) * size)


def shard_batch(batch, rank, world):
    """The rank's rows of a global event batch (numpy arrays or tensors)."""
    return {k: v[shard_rows(len(v), rank, world)] for k, v in batch.items()}


def shard_draws(draws, rank, world):
    """The rank's share of one step's global draws (`step.draw_step` for
    the global capacity n): the normalized interval samples ((n,) and the
    filter's (S - 1, n) generator) by event; the jitter, one per rendered
    ray in the (S, R, n) order of the draws (S lifetime samples, R render
    slices, slice-major), by event in each (S, R) row; the sparsity draws
    whole."""
    normalized = draws["normalized"]
    n = normalized["diff_start_ts"].shape[-1]
    rows = shard_rows(n, rank, world)
    out = dict(draws, normalized={k: v[..., rows]
                                  for k, v in normalized.items()})
    if draws.get("jitter") is not None:
        out["jitter"] = draws["jitter"].reshape(-1, n)[:, rows].reshape(-1)
    return out


def shard_render_config(rc, world):
    """A rank's render configuration: the sample budget and the configured
    block and superblock budgets (0, off, stays 0) over `world`."""
    def share(budget):
        return budget // world if budget else budget

    return dataclasses.replace(
        rc, sample_budget=share(rc.sample_budget),
        block_budget=share(rc.block_budget),
        superblock_budget=share(rc.superblock_budget))


def replicate(tensors, src=0):
    """Broadcast each tensor from rank `src` in place (bool tensors as
    bytes), and move each one's version counter, which the broadcast
    leaves as it was (the encode's bf16 table copy is keyed on it)."""
    for t in tensors:
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t,
                       src)
        torch.autograd.graph.increment_version(t)


def _buckets(tensors, bucket_bytes):
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes
                       or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


class StepCollectives:
    """The collectives of one rank's step (`step.make_train_step(...,
    shard=)`): the count all-reduce of the masked means, the gradient
    all-reduce and the metric reductions."""

    def __init__(self, world, sample_budget):
        self.world = int(world)
        self.sample_budget = int(sample_budget)

    def sum(self, counts):
        """The global sums of a 1-D tensor of counts."""
        counts = counts.clone()
        dist.all_reduce(counts)
        return counts

    def all_reduce_grads(self, params):
        """Sum every gradient over the ranks, in flat buckets."""
        grads = [p.grad for p in params if p.grad is not None]
        pending = []
        for bucket in _buckets(grads, BUCKET_BYTES):
            flat = (bucket[0] if len(bucket) == 1
                    and bucket[0].is_contiguous()
                    else torch.cat([g.reshape(-1) for g in bucket]))
            pending.append((bucket, flat, dist.all_reduce(flat,
                                                          async_op=True)))
        for bucket, flat, work in pending:
            work.wait()
            if flat is not bucket[0]:
                offset = 0
                for g in bucket:
                    g.copy_(flat[offset:offset + g.numel()].view_as(g))
                    offset += g.numel()

    def reduce_metrics(self, metrics):
        """The global metrics (see SUM_METRICS and the others) from each
        rank's detached ones: one asynchronous all-reduce per kind."""
        known = (set(SUM_METRICS) | set(MAX_METRICS) | set(MIN_METRICS)
                 | set(REPLICATED_METRICS) | set(DERIVED_METRICS))
        unknown = set(metrics) - known
        if unknown:
            raise KeyError(f"metrics without a reduction: {sorted(unknown)}")
        out = dict(metrics)
        pending = []
        for op, names in ((dist.ReduceOp.SUM, SUM_METRICS),
                          (dist.ReduceOp.MAX, MAX_METRICS),
                          (dist.ReduceOp.MIN, MIN_METRICS)):
            names = [k for k in names if k in metrics]
            if names:
                buf = torch.stack([metrics[k].reshape(()).to(torch.float64)
                                   for k in names])
                pending.append((names, buf, dist.all_reduce(
                    buf, op=op, async_op=True)))
        for names, buf, work in pending:
            work.wait()
            for i, k in enumerate(names):
                out[k] = buf[i].to(metrics[k].dtype)
        for k in RATE_METRICS:
            if k in out:
                out[k] = out[k] / self.world
        marched = out["num_marched_samples"].to(torch.float32)
        out["mean_num_samples_per_ray"] = marched / torch.clamp(
            out["num_rays"].to(torch.float32), min=1)
        out["sample_overflow_rate"] = marched / float(
            self.world * self.sample_budget)
        return out


def make_sharded_train_step(params, consts, optimizer, sc, loss_config,
                            world):
    """Data-parallel version of `training.step.make_train_step`: the same
    step_fn(occ_state, batch, draws, level_mask=None, prepass=True) ->
    metrics, taking the rank's shard of the batch and the draws
    (`shard_batch`, `shard_draws`) and returning the global metrics.
    `params.nerf.render_config` must be the rank's (`shard_render_config`).
    Returns (step_fn, its StepCollectives)."""
    collectives = StepCollectives(
        world, params.nerf.render_config.sample_budget)
    return step_lib.make_train_step(params, consts, optimizer, sc,
                                    loss_config, shard=collectives), \
        collectives


def digest(tensors):
    """An int64 checksum of the tensors' bits: equal tensors give equal
    digests on any device, in any summation order (integer sums wrap
    modulo 2^64)."""
    total = None
    for i, t in enumerate(tensors):
        flat = t.detach().contiguous().reshape(-1)
        if flat.dtype == torch.bool:
            bits = flat.to(torch.int64)
        else:
            bits = flat.view({1: torch.uint8, 2: torch.int16,
                              4: torch.int32, 8: torch.int64}[
                                  flat.element_size()]).to(torch.int64)
        weights = torch.arange(bits.numel(), device=bits.device) % 65521 \
            + (2 * i + 1)
        part = (bits * weights).sum()
        total = part if total is None else total + part
    return total


def replicas_agree(value):
    """True on every rank when the int64 scalar `value` is equal on all
    ranks (one all-reduce)."""
    both = torch.stack([value, -value])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    return bool(both[0] == -both[1])
