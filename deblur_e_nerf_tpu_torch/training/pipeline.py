"""Host-side training data pipeline (counterpart of
deblur_e_nerf_tpu/training/pipeline.py): a fixed-capacity event batch with
a validity prefix, and the dynamic active-batch-size controller."""

import numpy as np


class EventBatcher:
    def __init__(self, events, capacity, seed=0, dataset_len=None,
                 has_bayer=False, interleave=1):
        """events: packed events dict of numpy arrays; capacity: batch
        capacity N; dataset_len: optional trim of the event dataset;
        interleave: the data-parallel mesh size W. The active rows go
        round-robin over the W equal shards of the capacity, each shard's
        a prefix of it, so every rank gets an equal share (N must divide
        by W)."""
        self.events = events
        self.capacity = int(capacity)
        self.n = int(dataset_len or len(events["position"]))
        self.rng = np.random.Generator(np.random.Philox(seed))
        self.has_bayer = has_bayer
        self.interleave = max(int(interleave), 1)
        if self.capacity % self.interleave:
            raise ValueError(f"batch capacity {self.capacity} does not "
                             f"divide into {self.interleave} shards")

    def next_batch(self, active_size):
        """`active_size` random events (with replacement) in the first rows
        of a capacity-N batch (of each shard's rows, with `interleave`);
        numpy arrays."""
        active = int(min(max(active_size, 1), self.capacity))
        idx = self.rng.integers(0, self.n, size=active)
        cap = self.capacity
        k = np.arange(active)
        shard = cap // self.interleave
        rows = (k % self.interleave) * shard + k // self.interleave

        def take(key, dtype, fill=0):
            arr = self.events[key][idx]
            out = np.full((cap, *arr.shape[1:]), fill, dtype=dtype)
            out[rows] = arr
            return out

        valid = np.zeros(cap, bool)
        valid[rows] = True
        batch = {
            "position": take("position", np.float32),
            "start_ts": take("start_ts", np.int64),
            "end_ts": take("end_ts", np.int64, fill=1),
            "num_pos": take("num_pos", np.float32),
            "num_neg": take("num_neg", np.float32),
            "valid": valid,
        }
        if self.has_bayer:
            batch["channel_idx"] = take("channel_idx", np.int64)
        return batch


class BatchSizeController:
    """active ~= target_ray_samples / mean_num_samples_per_ray, clamped to
    [min_batch, capacity]."""

    def __init__(self, target_ray_samples, init_batch_size, capacity,
                 min_batch=1):
        self.target = float(target_ray_samples)
        self.capacity = int(capacity)
        self.active = int(min(init_batch_size, capacity))
        self.min_batch = int(max(1, min(min_batch, capacity)))

    def update(self, mean_num_samples_per_ray):
        m = float(mean_num_samples_per_ray)
        if m > 0 and np.isfinite(m):
            self.active = int(
                np.clip(self.target / m, self.min_batch, self.capacity))
        return self.active
