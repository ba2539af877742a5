"""Dense occupancy grid with EMA updates (counterpart of
deblur_e_nerf_tpu/models/occupancy.py).

A flat float32 `occs` buffer and a bool `binary` mask over a
`resolution^3` grid in contracted space (x-fastest cell order). During
warmup every cell is evaluated; afterwards n/4 uniform cells plus n/4
cells drawn from the occupied distribution get an EMA-max update, each
sampled cell decaying exactly once; the mask re-thresholds at
min(mean(occs), occ_thre) with the optional floor, max-relative and
occupied-fraction caps. `update` runs ops/occupancy.py chunk by chunk of
the evaluated cells (on the card its kernels, on the CPU their plain
versions): the cells' points, the field's densities, the EMA, then the
threshold.

Random draws are inputs (`draw_update`, `draw_occupied_cells` make them
from a torch.Generator), so tests can feed the JAX package's draws.
"""

from typing import NamedTuple

import torch

from ..ops import occupancy as occ_ops


class OccupancyGridState(NamedTuple):
    occs: torch.Tensor    # (num_cells,) float32 EMA occupancy
    binary: torch.Tensor  # (num_cells,) bool occupancy mask


def init_state(resolution, device):
    num_cells = int(resolution) ** 3
    return OccupancyGridState(
        occs=torch.zeros(num_cells, dtype=torch.float32, device=device),
        binary=torch.zeros(num_cells, dtype=torch.bool, device=device),
    )


def grid_index(u, resolution):
    """Contracted coords -> (flat x-fastest cell index, in-grid mask)."""
    cell = torch.floor(u * resolution).to(torch.int64)
    in_grid = torch.all((cell >= 0) & (cell < resolution), dim=-1)
    cell = cell.clamp(0, resolution - 1)
    flat = (cell[..., 2] * resolution + cell[..., 1]) * resolution \
        + cell[..., 0]
    return flat, in_grid


def query(binary, u, resolution):
    """Occupancy at contracted coordinates; False outside the grid."""
    flat, in_grid = grid_index(u, resolution)
    return binary[flat] & in_grid


def draw_occupied_cells(generator, num_cells, n, device):
    """Draws for `sample_occupied_cells`: fallback uniform cells and the
    inverse-CDF variates."""
    return {
        "fallback_cells": torch.randint(0, num_cells, (n,), device=device,
                                        generator=generator),
        "u": torch.rand(n, device=device, generator=generator),
    }


def sample_occupied_cells(binary, draws):
    """Cells ~ the occupied distribution (with replacement) by inverse-CDF
    over the mask; uniform fallback cells when nothing is occupied
    (ops/occupancy.py `sample_occupied`)."""
    return occ_ops.sample_occupied(binary, draws)


def draw_update(generator, resolution, warmup, device, num_cameras=0):
    """Draws for one `update`: cell jitter, for a sampled update the
    uniform cells and the occupied-cell draws, and with `num_cameras` (a
    cone angle) one camera per evaluated cell (`cam_ids`)."""
    num_cells = int(resolution) ** 3
    n = num_cells // 4
    if warmup:
        draws = {"jitter": torch.rand((num_cells, 3), device=device,
                                      generator=generator)}
    else:
        draws = {
            "uniform_cells": torch.randint(0, num_cells, (n,), device=device,
                                           generator=generator),
            "occupied": draw_occupied_cells(generator, num_cells, n, device),
            "jitter": torch.rand((2 * n, 3), device=device,
                                 generator=generator),
        }
    if num_cameras:
        draws["cam_ids"] = torch.randint(
            0, int(num_cameras), (draws["jitter"].shape[0],), device=device,
            generator=generator)
    return draws


class OccEval(NamedTuple):
    """density * step occupancy evaluation: the density call and its step
    (ops/occupancy.Steps): with a cone angle the step is the march's at
    each cell's distance from a camera position drawn for it,
    max(|o - x| * cone, step), zeroed outside (near, far)."""
    density_fn: object
    steps: occ_ops.Steps


def make_occ_eval_fn(density_fn, render_step_size, cone_angle,
                     near_plane=None, far_plane=None):
    """The OccEval of a density function (N, 3) -> (N, 1) and the
    march's step settings."""
    return OccEval(density_fn, occ_ops.Steps(
        float(render_step_size), float(cone_angle), near_plane, far_plane))


@torch.no_grad()
def update(state, occ_eval_fn, warmup, draws, *, resolution, aabb,
           contraction_type, occ_thre, ema_decay, thre_floor=0.0,
           max_occupied_fraction=1.0, thre_rel_max=0.0,
           camera_positions=None, chunk=1 << 19):
    """One occupancy-grid update. `occ_eval_fn` comes from
    `make_occ_eval_fn`; `warmup` selects the full-grid update (step <
    warmup_steps); `draws` comes from `draw_update` (with `cam_ids`, the
    evaluated cells' cameras among `camera_positions`). The density is
    evaluated in chunks of `chunk` cells (rounded down to a multiple of
    ops/occupancy.TILE) to bound memory, and each chunk's densities go
    into the EMA before the next is evaluated."""
    grid = occ_ops.Grid(int(resolution), tuple(float(v) for v in aabb),
                        contraction_type)
    steps = occ_eval_fn.steps
    if warmup:
        cells = ()
    else:
        cells = (draws["uniform_cells"],
                 sample_occupied_cells(state.binary, draws["occupied"]))
    n = draws["jitter"].shape[0]
    chunk = max(occ_ops.TILE, int(chunk) // occ_ops.TILE * occ_ops.TILE)

    def chunks():
        for start in range(0, n, chunk):
            x, step = occ_ops.points(
                grid, draws["jitter"], start, min(chunk, n - start), cells,
                steps, draws.get("cam_ids"), camera_positions)
            yield start, occ_eval_fn.density_fn(x), step

    occs, partials = occ_ops.ema(state.occs, ema_decay, chunks(),
                                 cells if cells else None,
                                 steps.render_step_size)
    binary, _ = occ_ops.threshold(occs, partials, occ_thre, thre_floor,
                                  thre_rel_max, max_occupied_fraction)
    return OccupancyGridState(occs=occs, binary=binary)
