"""Dense occupancy grid with EMA updates (counterpart of
deblur_e_nerf_tpu/models/occupancy.py).

A flat float32 `occs` buffer and a bool `binary` mask over a
`resolution^3` grid in contracted space (x-fastest cell order). During
warmup every cell is evaluated; afterwards n/4 uniform cells plus n/4
cells drawn from the occupied distribution get an EMA-max update, each
sampled cell decaying exactly once; the mask re-thresholds at
min(mean(occs), occ_thre) with the optional floor, max-relative and
occupied-fraction caps.

Random draws are inputs (`draw_update`, `draw_occupied_cells` make them
from a torch.Generator), so tests can feed the JAX package's draws.
"""

from typing import NamedTuple

import torch

from . import contraction as contraction_lib
from ..utils.device import constant


class OccupancyGridState(NamedTuple):
    occs: torch.Tensor    # (num_cells,) float32 EMA occupancy
    binary: torch.Tensor  # (num_cells,) bool occupancy mask


def init_state(resolution, device):
    num_cells = int(resolution) ** 3
    return OccupancyGridState(
        occs=torch.zeros(num_cells, dtype=torch.float32, device=device),
        binary=torch.zeros(num_cells, dtype=torch.bool, device=device),
    )


def cell_coords(resolution, device, cells=None):
    """Integer (M, 3) (x, y, z) coordinates of flat cells (all by default)."""
    if cells is None:
        cells = torch.arange(int(resolution) ** 3, device=device)
    cells = cells.to(torch.int64)
    r = int(resolution)
    return torch.stack([cells % r, (cells // r) % r, cells // (r * r)], -1)


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
    over the mask; uniform fallback cells when nothing is occupied."""
    num_cells = binary.shape[0]
    cdf = torch.cumsum(binary.to(torch.float32), dim=0)
    total = cdf[-1]
    u = draws["u"] * torch.clamp(total, min=1.0)
    occ_cells = torch.searchsorted(cdf, u, right=True).clamp(0, num_cells - 1)
    return torch.where(total > 0, occ_cells,
                       draws["fallback_cells"].to(torch.int64))


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


def make_occ_eval_fn(density_fn, render_step_size, cone_angle,
                     near_plane=None, far_plane=None):
    """density * step occupancy evaluation: occ_eval_fn(x, origins). With
    a cone angle the step is the march's at each cell's distance from a
    camera position drawn for it (`origins`, (N, 3)),
    max(|o - x| * cone, step), zeroed outside (near, far)."""

    def occ_eval_fn(x, origins=None):
        if cone_angle > 0.0:
            t = _norm(origins - x)
            step = torch.clamp(t * cone_angle, min=render_step_size)
            if near_plane is not None and far_plane is not None:
                step = torch.where((t > near_plane) & (t < far_plane), step,
                                   torch.zeros_like(step))
        else:
            step = render_step_size
        return (density_fn(x) * step)[..., 0]

    return occ_eval_fn


def _norm(v):
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


@torch.no_grad()
def update(state, occ_eval_fn, warmup, draws, *, resolution, aabb,
           contraction_type, occ_thre, ema_decay, thre_floor=0.0,
           max_occupied_fraction=1.0, thre_rel_max=0.0,
           camera_positions=None, chunk=1 << 19):
    """One occupancy-grid update. `warmup` selects the full-grid update
    (step < warmup_steps); `draws` comes from `draw_update` (with
    `cam_ids`, the evaluated cells' cameras among `camera_positions`). The
    density is evaluated in chunks of `chunk` cells to bound memory."""
    device = state.occs.device
    num_cells = state.occs.shape[0]
    aabb = constant(aabb, torch.float32, device)

    def eval_cells(cells):
        coords = cell_coords(resolution, device, cells).to(torch.float32)
        u = (coords + draws["jitter"]) / resolution
        x = contraction_lib.contract_inv(u, aabb, contraction_type)
        if "cam_ids" not in draws:
            return torch.cat([occ_eval_fn(xc) for xc in x.split(chunk)])
        ids = draws["cam_ids"].to(torch.int64)
        return torch.cat([
            occ_eval_fn(xc, camera_positions[ic])
            for xc, ic in zip(x.split(chunk), ids.split(chunk))])

    if warmup:
        occ = eval_cells(torch.arange(num_cells, device=device))
        occs = torch.maximum(state.occs * ema_decay, occ)
    else:
        cells = torch.cat([
            draws["uniform_cells"].to(torch.int64),
            sample_occupied_cells(state.binary, draws["occupied"]),
        ])
        occ = eval_cells(cells)
        sampled = torch.zeros(num_cells, dtype=torch.bool, device=device)
        sampled[cells] = True
        occs = torch.where(sampled, state.occs * ema_decay, state.occs)
        occs = occs.scatter_reduce(0, cells, occ, reduce="amax",
                                   include_self=True)
    thre = torch.clamp(occs.mean(), max=occ_thre)
    if thre_floor > 0.0:
        thre = torch.clamp(thre, min=thre_floor)
    if thre_rel_max > 0.0:
        thre = torch.maximum(thre, thre_rel_max * occs.max())
    if max_occupied_fraction < 1.0:
        thre = torch.maximum(
            thre, torch.quantile(occs, 1.0 - max_occupied_fraction))
    return OccupancyGridState(occs=occs, binary=occs > thre)
