"""The occupancy grid's update (counterpart of the JAX package's `update`,
deblur_e_nerf_tpu/models/occupancy.py:128, with `sample_occupied_cells`
:64, `_sample_cells` :91 and `make_occ_eval_fn` :103). models/occupancy.py
`update` runs them chunk by chunk of the evaluated cells:

  - `points(grid, jitter, start, count, cells, steps, cam_ids,
    camera_positions)` -> (x, step): the world points (count, 3) of
    lanes start .. start + count of the evaluated cell list (`cells`, a
    tuple of int64 lists read as their concatenation; () for the cells
    themselves, a warmup chunk), each cell's x-fastest coordinates plus
    its jitter over the resolution, through `contract_inv`; under a cone
    angle each lane's step max(|o - x| cone, render_step_size), 0 outside
    (near, far), from its camera `cam_ids` among `camera_positions`, else
    None (the step is render_step_size);
  - `ema(occs, decay, chunks, cells, step_size)` -> (occs, partials): the
    EMA-max of density x step over the chunks `(start, density, step)` of
    the field's densities at `points`' lanes: a warmup update (`cells`
    None) max(occs x decay, density x step) at every cell; a sampled one
    decays each listed cell once and takes the max of its contributions;
    `partials` are the new grid's float64 sums and maxima by tile of TILE
    cells (None on the CPU);
  - `threshold(occs, partials, occ_thre, thre_floor, thre_rel_max,
    max_occupied_fraction)` -> (binary, thre): min(mean, occ_thre), then
    the floor, thre_rel_max x max, and the (1 - fraction) quantile as
    torch.quantile forms it; binary = occs > thre;
  - `sample_occupied(binary, draws)` -> cells: inverse-CDF draws of
    occupied cells, the fallback cells when none is occupied.

On a CUDA tensor each wrapper launches its kernel of `csrc/occupancy.cu`
or raises; on a CPU tensor it runs its plain version (`*_reference`, the
port's former update code, held to the JAX package by the tests). The
`*_model` functions model the kernels' operation order in plain torch
(the points lane by lane, the sampler's group search, the quantile's
radix select, the threshold's partials), which the CPU tests hold to the
plain versions. The kernels allocate nothing: each wrapper makes one
allocation for its outputs and scratch (typed views of one buffer), since
every allocator call is an operator call. No wrapper reads a device value
back: the threshold stays on the card.

`POINTS_LAUNCHES`, `EMA_LAUNCHES`, `THRESHOLD_LAUNCHES` and
`SAMPLE_LAUNCHES` count the calls of the library's entry points
(`occ_ema` one a chunk, and one more for a sampled update's last pass),
not the device launches: `occ_points` and `occ_ema` launch one kernel a
call (a sampled update's EMA first clears its keys with a memset,
`occ_ema_begin`, uncounted), `occ_threshold` two, or with the quantile a
memset and ten (two for each of DIGITS passes), `occ_sample_occupied`
three.
"""

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import contraction as contraction_lib
from ..utils.device import constant
from ._cuda_build import carve as _carve, launch as _launch, library

TILE = 1024          # cells a partial of the EMA (csrc/occupancy.cu kTile)
SAMPLE_TILE = 4096   # cells a tile of the sampler (kSampleTile)
GROUP = 128          # cells a group of the sampler's tile (kGroup)
DIGITS = 4    # the radix select's 8-bit digits

POINTS_LAUNCHES = 0     # occ_points calls since the last reset
EMA_LAUNCHES = 0        # occ_ema calls
THRESHOLD_LAUNCHES = 0  # occ_threshold calls
SAMPLE_LAUNCHES = 0     # occ_sample_occupied calls

_CONTRACTIONS = {contraction_lib.ContractionType.AABB: 0,
                 contraction_lib.ContractionType.UN_BOUNDED_SPHERE: 1,
                 contraction_lib.ContractionType.UN_BOUNDED_TANH: 2}
_EPS = 1e-6  # contraction.contract_inv's clamps
_WARMUP_CHUNK, _SAMPLED_CHUNK, _SAMPLED_FINISH = 0, 1, 2


class Grid(NamedTuple):
    resolution: int
    aabb: tuple
    contraction_type: contraction_lib.ContractionType


class Steps(NamedTuple):
    """The occupancy evaluation's step: render_step_size, or under a cone
    angle max(t cone, render_step_size) at a camera's distance t, zeroed
    outside (near, far) when both planes are given."""
    render_step_size: float
    cone_angle: float = 0.0
    near_plane: Optional[float] = None
    far_plane: Optional[float] = None


# ---------------------------------------------------------------------------
# the plain version


def cell_coords(resolution, device, cells=None):
    """Integer (M, 3) (x, y, z) coordinates of flat cells (all by default)."""
    if cells is None:
        cells = torch.arange(int(resolution) ** 3, device=device)
    cells = cells.to(torch.int64)
    r = int(resolution)
    return torch.stack([cells % r, (cells // r) % r, cells // (r * r)], -1)


def _norm(v):
    # sqrt((x^2 + y^2) + z^2) in elementwise ops, as contraction._norm: a
    # reduction kernel may order the sum by the tensor's shape
    x, y, z = v.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)


def step_reference(steps, x, origins):
    """The cone-angle step at points x (N, 3) from origins (N, 3)."""
    t = _norm(origins - x)
    step = torch.clamp(t * steps.cone_angle, min=steps.render_step_size)
    if steps.near_plane is not None and steps.far_plane is not None:
        step = torch.where((t > steps.near_plane) & (t < steps.far_plane),
                           step, torch.zeros_like(step))
    return step


def _lanes(cells, start, count, device):
    if not cells:
        return torch.arange(start, start + count, device=device)
    return torch.cat([c.to(torch.int64) for c in cells])[start:start + count]


def points_reference(grid, jitter, start, count, cells=(), steps=None,
                     cam_ids=None, camera_positions=None):
    device = jitter.device
    coords = cell_coords(grid.resolution, device,
                         _lanes(cells, start, count, device))
    u = (coords.to(torch.float32) + jitter[start:start + count]) \
        / grid.resolution
    x = contraction_lib.contract_inv(
        u, constant(grid.aabb, torch.float32, device), grid.contraction_type)
    if steps is None or steps.cone_angle <= 0.0:
        return x, None
    ids = cam_ids[start:start + count].to(torch.int64)
    return x, step_reference(steps, x, camera_positions[ids])


def _contributions(density, step, step_size):
    return density.reshape(density.shape[0]) * (
        step_size if step is None else step)


def ema_reference(occs, decay, chunks, cells=None, step_size=0.0):
    if cells is None:
        out = torch.empty_like(occs)
        for start, density, step in chunks:
            n = density.shape[0]
            out[start:start + n] = torch.maximum(
                occs[start:start + n] * decay,
                _contributions(density, step, step_size))
        return out, None
    cells = torch.cat([c.to(torch.int64) for c in cells])
    sampled = torch.zeros(occs.shape[0], dtype=torch.bool, device=occs.device)
    sampled[cells] = True
    out = torch.where(sampled, occs * decay, occs)
    for start, density, step in chunks:
        n = density.shape[0]
        out.scatter_reduce_(0, cells[start:start + n],
                            _contributions(density, step, step_size),
                            reduce="amax", include_self=True)
    return out, None


def threshold_reference(occs, occ_thre, thre_floor=0.0, thre_rel_max=0.0,
                        max_occupied_fraction=1.0):
    thre = torch.clamp(occs.mean(), max=occ_thre)
    if thre_floor > 0.0:
        thre = torch.clamp(thre, min=thre_floor)
    if thre_rel_max > 0.0:
        thre = torch.maximum(thre, thre_rel_max * occs.max())
    if max_occupied_fraction < 1.0:
        thre = torch.maximum(
            thre, torch.quantile(occs, 1.0 - max_occupied_fraction))
    return occs > thre, thre


def sample_occupied_reference(binary, draws):
    num_cells = binary.shape[0]
    cdf = torch.cumsum(binary.to(torch.float32), dim=0)
    total = cdf[-1]
    u = draws["u"] * torch.clamp(total, min=1.0)
    occ_cells = torch.searchsorted(cdf, u, right=True).clamp(0, num_cells - 1)
    return torch.where(total > 0, occ_cells,
                       draws["fallback_cells"].to(torch.int64))


# ---------------------------------------------------------------------------
# the kernels' parameters and the models of the kernels


def _values(grid, steps):
    """csrc/occupancy.cu PointsParams, each number formed as the plain
    version forms it: the float32 rounding of the Python double it hands
    PyTorch."""
    f32 = np.float32
    steps = steps or Steps(0.0)
    cone = steps.cone_angle > 0.0
    planes = steps.near_plane is not None and steps.far_plane is not None
    return dict(
        aabb_lo=[f32(v) for v in grid.aabb[:3]],
        aabb_hi=[f32(v) for v in grid.aabb[3:]],
        inv_res=f32(1.0) / f32(grid.resolution),
        sphere_max=f32(2 - _EPS), min_mag=f32(_EPS),
        tanh_lo=f32(-1 + _EPS), tanh_hi=f32(1 - _EPS),
        step=f32(steps.render_step_size), cone=f32(steps.cone_angle),
        near_plane=f32(steps.near_plane if planes else 0.0),
        far_plane=f32(steps.far_plane if planes else 0.0),
        contraction=_CONTRACTIONS[grid.contraction_type], cone_on=int(cone),
        planes=int(planes), resolution=int(grid.resolution))


def _scalar(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def points_model(grid, jitter, start, count, cells=(), steps=None,
                 cam_ids=None, camera_positions=None, cuda_division=False):
    """The points kernel lane by lane: each float32 operation in the
    kernel's order. `cuda_division`: the plain version's `u /
    resolution` as torch's CUDA kernel computes it for a Python divisor, a
    product with the float32 reciprocal (the kernel's form); else as the
    CPU's, a quotient."""
    device = jitter.device
    q = _values(grid, steps)
    lo = [_scalar(v, device) for v in q["aabb_lo"]]
    ext = [_scalar(h, device) - lo_i for h, lo_i in zip(q["aabb_hi"], lo)]
    cell = _lanes(cells, start, count, device)
    r = q["resolution"]
    coords = (cell % r, (cell // r) % r, cell // (r * r))
    jit = jitter[start:start + count]
    u = []
    for k in range(3):
        v = coords[k].to(torch.float32) + jit[:, k]
        u.append(v * _scalar(q["inv_res"], device) if cuda_division
                 else v / _scalar(float(r), device))
    if q["contraction"] == 1:
        w = [(ui - 0.5) * 4.0 for ui in u]
        mag = torch.clamp(torch.sqrt(w[0] * w[0] + w[1] * w[1]
                                     + w[2] * w[2]),
                          max=_scalar(q["sphere_max"], device))
        safe = torch.clamp(mag, min=_scalar(q["min_mag"], device))
        v = [torch.where(mag > 1.0, wi / safe / (2.0 - mag), wi) for wi in w]
        x = [lo[i] + (v[i] + 1.0) * 0.5 * ext[i] for i in range(3)]
    elif q["contraction"] == 2:
        t = [torch.clamp(ui * 2.0 - 1.0, _scalar(q["tanh_lo"], device),
                         _scalar(q["tanh_hi"], device)) for ui in u]
        # atanh of the (count, 3) stack, as the plain version takes it: the
        # CPU's vectorized atanh may round a lane by its position
        a = torch.atanh(torch.stack(t, -1)).unbind(-1)
        x = [lo[i] + (a[i] + 0.5) * ext[i] for i in range(3)]
    else:
        x = [lo[i] + u[i] * ext[i] for i in range(3)]
    x_out = torch.stack(x, -1)
    if not q["cone_on"]:
        return x_out, None
    o = camera_positions[cam_ids[start:start + count].to(torch.int64)]
    v = [o[:, k] - x[k] for k in range(3)]
    t = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    step = torch.clamp(t * _scalar(q["cone"], device),
                       min=_scalar(q["step"], device))
    if q["planes"]:
        inside = (t > _scalar(q["near_plane"], device)) \
            & (t < _scalar(q["far_plane"], device))
        step = torch.where(inside, step, 0.0)
    return x_out, step


def sample_occupied_model(binary, draws):
    """The sampler's integer search: the occupied cells counted by tile of
    SAMPLE_TILE and by group of GROUP within it, the tiles' inclusive
    offsets and each tile's groups' exclusive ones; for each variate m =
    floor(u x max(total, 1)) in float32, the first tile whose offset
    passes m, the last of its groups whose offset does not pass the rest,
    and the rest's occupied cell in that group; the fallback cell where
    nothing is occupied, the last cell where m reaches the total."""
    n_cells = binary.shape[0]
    n_tiles = -(-n_cells // SAMPLE_TILE)
    padded = torch.zeros(n_tiles * SAMPLE_TILE, dtype=torch.int64,
                         device=binary.device)
    padded[:n_cells] = binary.to(torch.int64)
    ones = padded.reshape(n_tiles, SAMPLE_TILE // GROUP, GROUP)
    counts = ones.sum(2)
    group_excl = torch.cumsum(counts, 1) - counts
    tiles = torch.cumsum(counts.sum(1), 0)
    total = tiles[-1]
    target = draws["u"] * torch.clamp(total.to(torch.float32), min=1.0)
    m = torch.floor(target).to(torch.int64)
    t = torch.searchsorted(tiles, m, right=True).clamp(max=n_tiles - 1)
    r = m - torch.where(t > 0, tiles[(t - 1).clamp(min=0)], 0)
    g = (group_excl[t] <= r[:, None]).sum(1) - 1
    r = r - group_excl[t, g]
    offset = torch.argmax((torch.cumsum(ones[t, g], 1) > r[:, None])
                          .to(torch.int64), 1)
    cells = torch.where(m >= total, n_cells - 1,
                        t * SAMPLE_TILE + g * GROUP + offset)
    return torch.where(total > 0, cells,
                       draws["fallback_cells"].to(torch.int64))


def order_keys(x):
    """The kernels' order-preserving uint32 key of each float (as int64):
    every NaN above +inf, -0 as +0, every key at least -inf's."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    bits = torch.where(bits == 0x80000000, 0, bits)
    keys = torch.where(bits >= 0x80000000, bits ^ 0xffffffff,
                       bits | 0x80000000)
    return torch.where(torch.isnan(x), 0xffffffff, keys)


def key_values(keys):
    """The floats of `order_keys`' keys."""
    keys = torch.as_tensor(keys, dtype=torch.int64)
    bits = torch.where(keys >= 0x80000000, keys & 0x7fffffff,
                       keys ^ 0xffffffff)
    return bits.to(torch.int32).view(torch.float32)


def order_statistics_model(occs, ranks):
    """The radix select: the ranks-th smallest keys (0-based), found digit
    by digit (8 bits, most significant first) from the histograms of the
    keys that match each rank's prefix. Returns their floats."""
    keys = order_keys(occs)
    found = []
    for rank in ranks:
        prefix, rem = 0, int(rank)
        for d in range(DIGITS):
            shift = 24 - 8 * d
            match = (keys >> (shift + 8)) == (prefix >> (shift + 8))
            hist = torch.bincount((keys[match] >> shift) & 0xff,
                                  minlength=256)
            incl = torch.cumsum(hist, 0)
            digit = int(torch.searchsorted(incl, torch.tensor(rem),
                                           right=True))
            rem -= int(incl[digit - 1]) if digit else 0
            prefix |= digit << shift
        found.append(key_values(torch.tensor(prefix, dtype=torch.int64)))
    return found


def quantile_model(occs, q):
    """torch.quantile(occs, q) as the threshold kernel forms it: the rank
    q x (n - 1) in float32 (the last index where a NaN is present), its
    floor and ceiling as order statistics (`order_statistics_model`), the
    weight rank - floor, and torch.lerp of the two (its two-branch form;
    the kernel's is the fused multiply-add nvcc makes of torch's lerp on
    the card)."""
    n = occs.shape[0]
    last = np.float32(n - 1)
    rank = last if bool(torch.isnan(occs).any()) \
        else np.float32(q) * last
    below, above = int(rank), int(math.ceil(rank))
    weight = np.float32(rank - np.float32(below))
    lo, hi = order_statistics_model(occs, (min(below, n - 1),
                                           min(above, n - 1)))
    return torch.lerp(lo, hi, torch.tensor(weight))


def partials_model(occs):
    """The EMA kernel's partials: each tile's float64 sum and its maximum
    (NaN where the tile holds one)."""
    import torch.nn.functional as F

    pad = -(-occs.shape[0] // TILE) * TILE - occs.shape[0]
    psum = F.pad(occs.double(), (0, pad)).reshape(-1, TILE).sum(1)
    pmax = F.pad(occs, (0, pad), value=-math.inf).reshape(-1, TILE).amax(1)
    return psum, pmax


def threshold_model(occs, occ_thre, thre_floor=0.0, thre_rel_max=0.0,
                    max_occupied_fraction=1.0):
    """(binary, thre) with the mean from `partials_model`'s float64 sums
    and the quantile from `quantile_model`."""
    psum, pmax = partials_model(occs)
    mean = torch.tensor(float(psum.sum()) / occs.shape[0],
                        dtype=torch.float32, device=occs.device)
    thre = torch.clamp(mean, max=occ_thre)
    if thre_floor > 0.0:
        thre = torch.clamp(thre, min=thre_floor)
    if thre_rel_max > 0.0:
        thre = torch.maximum(thre, thre_rel_max * pmax.max())
    if max_occupied_fraction < 1.0:
        thre = torch.maximum(thre, quantile_model(
            occs, 1.0 - max_occupied_fraction).to(thre.device))
    return occs > thre, thre


# ---------------------------------------------------------------------------
# the kernels


class _PointsParams(ctypes.Structure):
    """csrc/occupancy.cu PointsParams."""
    _fields_ = ([("aabb_lo", ctypes.c_float * 3),
                 ("aabb_hi", ctypes.c_float * 3)]
                + [(name, ctypes.c_float) for name in (
                    "inv_res", "sphere_max", "min_mag", "tanh_lo", "tanh_hi",
                    "step", "cone", "near_plane", "far_plane")]
                + [(name, ctypes.c_int32) for name in (
                    "contraction", "cone_on", "planes")]
                + [("resolution", ctypes.c_int64)])


class _ThresholdParams(ctypes.Structure):
    """csrc/occupancy.cu ThresholdParams."""
    _fields_ = ([(name, ctypes.c_float) for name in (
                    "occ_thre", "thre_floor", "thre_rel_max", "q")]
                + [(name, ctypes.c_int32) for name in (
                    "use_floor", "use_rel_max", "use_quantile", "pad")]
                + [(name, ctypes.c_int64) for name in ("n_cells", "n_tiles")])


SELECT_STATE_BYTES = 64  # a SelectState, rounded up


@functools.lru_cache(maxsize=None)
def _points_params(grid, steps):
    """The PointsParams of a grid and its steps, made once (callers must
    not write to it)."""
    v = _values(grid, steps)
    p = _PointsParams()
    for name, _ in _PointsParams._fields_:
        value = v[name]
        if isinstance(value, list):
            value = (ctypes.c_float * 3)(*[float(x) for x in value])
        setattr(p, name, value)
    return p


def _require(t, name, dtype, numel, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the grid on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, want {numel}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cell_lists(cells, device):
    """([(pointer, count) of each of two int64 cell lists, (None, 0) for
    an empty or absent one], the lists to keep alive over the launch)."""
    if len(cells) > 2:
        raise ValueError("at most two cell lists")
    lists = [c if c.dtype == torch.int64 else c.to(torch.int64)
             for c in cells]
    for i, c in enumerate(lists):
        _require(c, f"cells[{i}]", torch.int64, None, device)
    lists += [None] * (2 - len(lists))
    return [(None, 0) if c is None or c.numel() == 0
            else (c.data_ptr(), c.numel()) for c in lists], lists


def points(grid, jitter, start, count, cells=(), steps=None, cam_ids=None,
           camera_positions=None):
    """(x, step or None); see the module docstring."""
    global POINTS_LAUNCHES
    if not jitter.is_cuda:
        return points_reference(grid, jitter, start, count, cells, steps,
                                cam_ids, camera_positions)
    device = jitter.device
    lanes = jitter.shape[0]
    _require(jitter, "jitter", torch.float32, 3 * lanes, device)
    if count < 1 or start < 0 or start + count > lanes:
        raise ValueError(f"lanes {start} .. {start + count} of {lanes}")
    (a, b), keep = _cell_lists(cells, device)
    if cells and a[1] + b[1] != lanes:
        raise ValueError(f"{a[1] + b[1]} listed cells, {lanes} jitter rows")
    cone = steps is not None and steps.cone_angle > 0.0
    if cone:
        if cam_ids is None or camera_positions is None:
            raise ValueError("a cone-angle step takes cam_ids and the "
                             "camera positions")
        _require(cam_ids, "cam_ids", torch.int64, lanes, device)
        _require(camera_positions, "camera_positions", torch.float32, None,
                 device)
        x, step = _carve(device, (3 * count, torch.float32),
                         (count, torch.float32))
    else:
        (x,), step = _carve(device, (3 * count, torch.float32)), None
    params = _points_params(grid, steps)
    _launch(
        library().occ_points, device, ctypes.addressof(params), a[0], a[1],
        b[0], b[1], start, count, jitter.data_ptr(),
        cam_ids.data_ptr() if cone else None,
        camera_positions.data_ptr() if cone else None,
        camera_positions.shape[0] if cone else 0, x.data_ptr(),
        step.data_ptr() if cone else None)
    POINTS_LAUNCHES += 1
    del keep
    return x.view(count, 3), step


def _chunk_inputs(density, step, device):
    n = density.shape[0]
    if density.dim() not in (1, 2) or (density.dim() == 2
                                       and density.shape[1] != 1):
        raise ValueError(f"density must be (n,) or (n, 1), got "
                         f"{tuple(density.shape)}")
    if density.device != device or density.dtype != torch.float32:
        raise TypeError(f"density is {density.dtype} on {density.device}, "
                        f"the kernel takes float32 on {device}")
    if step is not None:
        _require(step, "step", torch.float32, n, device)
    return n, density.stride(0)


def ema(occs, decay, chunks, cells=None, step_size=0.0):
    """(occs, partials); see the module docstring. `chunks` yields (start,
    density, step); a warmup update's chunks must cover every cell, each
    starting at a multiple of TILE."""
    global EMA_LAUNCHES
    if not occs.is_cuda:
        return ema_reference(occs, decay, chunks, cells, step_size)
    device, n_cells = occs.device, occs.shape[0]
    _require(occs, "occs", torch.float32, n_cells, device)
    n_tiles = -(-n_cells // TILE)
    sampled = cells is not None
    out, keys, psum, pmax = _carve(
        device, (n_cells, torch.float32),
        (n_cells if sampled else 0, torch.int32), (n_tiles, torch.float64),
        (n_tiles, torch.float32))
    fn = library().occ_ema
    f_decay, f_step = float(np.float32(decay)), float(np.float32(step_size))
    if sampled:
        (a, b), keep = _cell_lists(cells, device)
        _launch(library().occ_ema_begin, device, keys.data_ptr(), n_cells)
    covered = 0
    for start, density, step in chunks:
        n, stride = _chunk_inputs(density, step, device)
        step_ptr = None if step is None else step.data_ptr()
        if sampled:
            _launch(fn, device, _SAMPLED_CHUNK, occs.data_ptr(),
                    out.data_ptr(), keys.data_ptr(), n_cells, f_decay,
                    density.data_ptr(), stride, step_ptr, f_step, a[0], a[1],
                    b[0], b[1], start, n, psum.data_ptr(), pmax.data_ptr())
        else:
            if start != covered or start % TILE:
                raise ValueError(f"a warmup chunk at {start}: chunks must "
                                 f"follow each other from 0 in multiples "
                                 f"of {TILE}")
            _launch(fn, device, _WARMUP_CHUNK, occs.data_ptr(),
                    out.data_ptr(), None, n_cells, f_decay,
                    density.data_ptr(), stride, step_ptr, f_step, None, 0,
                    None, 0, start, n, psum.data_ptr(), pmax.data_ptr())
        covered = start + n
        EMA_LAUNCHES += 1
    if sampled:
        _launch(fn, device, _SAMPLED_FINISH, occs.data_ptr(),
                out.data_ptr(), keys.data_ptr(), n_cells, f_decay, None, 0,
                None, 0.0, None, 0, None, 0, 0, 0, psum.data_ptr(),
                pmax.data_ptr())
        EMA_LAUNCHES += 1
        del keep
    elif covered != n_cells:
        raise ValueError(f"the warmup chunks covered {covered} of "
                         f"{n_cells} cells")
    return out, (psum, pmax)


def threshold(occs, partials, occ_thre, thre_floor=0.0, thre_rel_max=0.0,
              max_occupied_fraction=1.0):
    """(binary, thre); see the module docstring. `partials`: `ema`'s."""
    global THRESHOLD_LAUNCHES
    if not occs.is_cuda:
        return threshold_reference(occs, occ_thre, thre_floor, thre_rel_max,
                                   max_occupied_fraction)
    device, n_cells = occs.device, occs.shape[0]
    _require(occs, "occs", torch.float32, n_cells, device)
    if partials is None:
        raise ValueError("the threshold takes the EMA's partials")
    n_tiles = -(-n_cells // TILE)
    psum, pmax = partials
    _require(psum, "partial sums", torch.float64, n_tiles, device)
    _require(pmax, "partial maxima", torch.float32, n_tiles, device)
    use_q = max_occupied_fraction < 1.0
    binary, thre, hist, state = _carve(
        device, (n_cells, torch.bool), (1, torch.float32),
        (DIGITS * 2 * 256 if use_q else 0, torch.int32),
        (SELECT_STATE_BYTES if use_q else 0, torch.uint8))
    p = _ThresholdParams(
        occ_thre=occ_thre, thre_floor=thre_floor, thre_rel_max=thre_rel_max,
        q=1.0 - max_occupied_fraction, use_floor=int(thre_floor > 0.0),
        use_rel_max=int(thre_rel_max > 0.0), use_quantile=int(use_q), pad=0,
        n_cells=n_cells, n_tiles=n_tiles)
    _launch(library().occ_threshold, device, ctypes.addressof(p),
            occs.data_ptr(), psum.data_ptr(), pmax.data_ptr(),
            hist.data_ptr() if use_q else None,
            state.data_ptr() if use_q else None, thre.data_ptr(),
            binary.data_ptr())
    THRESHOLD_LAUNCHES += 1
    return binary, thre.view(())


def sample_occupied(binary, draws):
    """Cells ~ the occupied cells; see the module docstring."""
    global SAMPLE_LAUNCHES
    if not binary.is_cuda:
        return sample_occupied_reference(binary, draws)
    device, n_cells = binary.device, binary.shape[0]
    _require(binary, "binary", torch.bool, n_cells, device)
    u, fallback = draws["u"], draws["fallback_cells"]
    n = u.shape[0]
    if fallback.dtype != torch.int64:
        fallback = fallback.to(torch.int64)
    _require(u, "u", torch.float32, n, device)
    _require(fallback, "fallback_cells", torch.int64, n, device)
    if n == 0:
        return fallback.clone()
    n_tiles = -(-n_cells // SAMPLE_TILE)
    out, tiles, groups, total = _carve(
        device, (n, torch.int64), (n_tiles, torch.int32),
        (n_tiles * (SAMPLE_TILE // GROUP), torch.int32), (1, torch.int64))
    _launch(library().occ_sample_occupied, device, binary.data_ptr(),
            n_cells, u.data_ptr(), fallback.data_ptr(), n, tiles.data_ptr(),
            groups.data_ptr(), total.data_ptr(), out.data_ptr())
    SAMPLE_LAUNCHES += 1
    return out
