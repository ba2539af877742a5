"""Event stream loading and packed event intervals (counterpart of
deblur_e_nerf_tpu/data/events.py), numpy only.

For each event i at pixel p the packed interval is {position=pos_i,
start_ts=prev_ts(p), end_ts=t_i, num_pos=pol_i, num_neg=1-pol_i}; it is
valid iff an earlier event at p exists with a strictly smaller timestamp.
The maximum refractory period is the minimum inter-event interval over
all per-pixel substreams after de-duplicating equal timestamps. A stable
sort by pixel turns the per-pixel windows into shifted-array operations.

Undistortion is done only for an undistorted calibration (empty or
all-zero distortion parameters); a distorted calibration raises until the
undistortion is ported (ROADMAP Queue A 8). The port's cache files are
named apart from the JAX package's.
"""

import os

import numpy as np

RAW_EVENTS_FILENAME = "raw_events.npz"
CAMERA_CALIBRATION_FILENAME = "camera_calibration.npz"
PACKED_EVENTS_FILENAME = "events_torch.npz"
MAX_REFRACTORY_PERIOD_FILENAME = "max_refractory_period_torch.npy"

RAW_EVENT_POSITION_KEY = "position"
RAW_EVENT_TIMESTAMP_KEY = "timestamp"
RAW_EVENT_POLARITY_KEY = "polarity"
IMG_HEIGHT_KEY = "img_height"
IMG_WIDTH_KEY = "img_width"
DISTORTION_MODEL_KEY = "distortion_model"
DISTORTION_PARAMS_KEY = "distortion_params"
INTRINSICS_KEY = "intrinsics"
BAYER_PATTERN_KEY = "bayer_pattern"
NULL_BAYER_PATTERN = ""
COLOR_CHANNEL_NAME_TO_INDEX = {"R": 0, "G": 1, "B": 2}


def load_raw_events(root_directory):
    return np.load(os.path.join(root_directory, RAW_EVENTS_FILENAME))


def load_camera_calibration(root_directory):
    return np.load(os.path.join(root_directory, CAMERA_CALIBRATION_FILENAME),
                   allow_pickle=False)


def _pixel_runs(positions, img_width):
    """Stable-sort event indices by pixel id; (order, run-start mask)."""
    pixel_id = (positions[:, 1].astype(np.int64) * np.int64(img_width)
                + positions[:, 0].astype(np.int64))
    order = np.argsort(pixel_id, kind="stable")
    sorted_pid = pixel_id[order]
    run_start = np.empty(len(order), dtype=bool)
    if len(order):
        run_start[0] = True
        run_start[1:] = sorted_pid[1:] != sorted_pid[:-1]
    return order, run_start


def pack_events(positions, timestamps, polarities, img_height, img_width):
    """Packed intervals of a time-ordered raw (x, y, t, p) stream, in
    stream order (valid events only)."""
    if not len(positions) == len(timestamps) == len(polarities):
        raise ValueError("positions, timestamps, polarities differ in length")
    positions = positions.astype(np.int64)
    polarities = polarities.astype(np.int64)
    order, run_start = _pixel_runs(positions, img_width)
    sorted_ts = timestamps[order]
    prev_ts = np.empty_like(sorted_ts)
    if len(sorted_ts):
        prev_ts[1:] = sorted_ts[:-1]
        prev_ts[0] = sorted_ts[0]
    valid_sorted = (~run_start) & (prev_ts != sorted_ts)
    start_ts = np.empty_like(timestamps)
    start_ts[order] = prev_ts
    valid = np.empty(len(timestamps), dtype=bool)
    valid[order] = valid_sorted
    return {
        "position": positions[valid],
        "start_ts": start_ts[valid],
        "end_ts": timestamps[valid],
        "num_pos": polarities[valid],
        "num_neg": 1 - polarities[valid],
    }


def extract_max_refractory_period(positions, timestamps, img_height,
                                  img_width):
    """Min inter-event interval across per-pixel substreams (distinct ts)."""
    order, run_start = _pixel_runs(positions, img_width)
    sorted_ts = timestamps[order]
    distinct = np.empty(len(sorted_ts), dtype=bool)
    if len(sorted_ts):
        distinct[0] = True
        distinct[1:] = run_start[1:] | (sorted_ts[1:] != sorted_ts[:-1])
    dedup_ts = sorted_ts[distinct]
    dedup_run_start = run_start[distinct]
    if len(dedup_ts) < 2:
        return np.array(float("inf"))
    intervals = dedup_ts[1:] - dedup_ts[:-1]
    same_pixel = ~dedup_run_start[1:]
    if not np.any(same_pixel):
        return np.array(float("inf"))
    return np.asarray(intervals[same_pixel].min())


def colorize_events(events, bayer_pattern):
    """Bayer color-channel index per event from pixel parity."""
    if bayer_pattern == NULL_BAYER_PATTERN:
        return events
    if len(bayer_pattern) != 4 or set(bayer_pattern) != set(
            COLOR_CHANNEL_NAME_TO_INDEX):
        raise ValueError(f"invalid bayer pattern {bayer_pattern!r}")
    channel_of_quadrant = np.array(
        [COLOR_CHANNEL_NAME_TO_INDEX[c] for c in bayer_pattern],
        dtype=np.uint8)
    is_x_odd = (events["position"][:, 0] % 2).astype(np.int64)
    is_y_odd = (events["position"][:, 1] % 2).astype(np.int64)
    events = dict(events)
    events["channel_idx"] = channel_of_quadrant[is_y_odd * 2 + is_x_odd]
    return events


def undistort_events(events, distortion_model, distortion_params,
                     intrinsics):
    """Float64 positions; identity for an undistorted calibration."""
    events = dict(events)
    events["position"] = events["position"].astype(np.float64)
    params = np.asarray(distortion_params, dtype=np.float64)
    if params.size == 0 or not np.any(params):
        return events
    raise NotImplementedError(
        f"undistortion ({distortion_model!r}) is not ported yet (ROADMAP "
        "Queue A 8); the port reads undistorted calibrations only")


class EventDataset:
    """Packed event intervals, cached next to the raw stream; an optional
    permutation seed reshuffles the dataset deterministically."""

    def __init__(self, root_directory, permutation_seed=None):
        self.root_directory = root_directory
        self.events = self._load_or_build(root_directory)
        if permutation_seed is not None:
            n = len(self.events["position"])
            rng = np.random.Generator(np.random.Philox(permutation_seed))
            indices = rng.permutation(n)
            self.events = {k: v[indices] for k, v in self.events.items()}

    @staticmethod
    def _load_or_build(root_directory):
        cache_path = os.path.join(root_directory, PACKED_EVENTS_FILENAME)
        if os.path.isfile(cache_path):
            with np.load(cache_path) as f:
                return {k: f[k] for k in f.files}
        calib = load_camera_calibration(root_directory)
        raw = load_raw_events(root_directory)
        events = pack_events(
            raw[RAW_EVENT_POSITION_KEY], raw[RAW_EVENT_TIMESTAMP_KEY],
            raw[RAW_EVENT_POLARITY_KEY], int(calib[IMG_HEIGHT_KEY]),
            int(calib[IMG_WIDTH_KEY]))
        events = colorize_events(events, str(calib[BAYER_PATTERN_KEY]))
        events = undistort_events(
            events, calib[DISTORTION_MODEL_KEY],
            calib[DISTORTION_PARAMS_KEY], calib[INTRINSICS_KEY])
        np.savez(cache_path, **events)
        return events

    def __len__(self):
        return len(self.events["position"])


def load_max_refractory_period(root_directory):
    """Load (or extract and cache) the dataset's max refractory period."""
    cache_path = os.path.join(root_directory, MAX_REFRACTORY_PERIOD_FILENAME)
    if os.path.isfile(cache_path):
        return np.load(cache_path)
    calib = load_camera_calibration(root_directory)
    raw = load_raw_events(root_directory)
    max_rp = extract_max_refractory_period(
        raw[RAW_EVENT_POSITION_KEY], raw[RAW_EVENT_TIMESTAMP_KEY],
        int(calib[IMG_HEIGHT_KEY]), int(calib[IMG_WIDTH_KEY]))
    np.save(cache_path, max_rp)
    return max_rp
