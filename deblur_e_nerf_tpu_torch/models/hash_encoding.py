"""Multi-resolution grid encodings (counterpart of
deblur_e_nerf_tpu/models/hash_encoding.py).

Same level geometry and table layout as the JAX package (`grid_layout`,
including the 128-row segment alignment), so tables move between the two
packages unchanged. Per level the forward finds the sample's cell, gathers
the corner features as `compute_dtype` rows (bfloat16 on the flagship)
through `ops/gather_rows.py` and interpolates trilinearly in float32
through `ops/corner_sum.py` (a CUDA kernel each on the card):

  - 'dense' levels gather one (8F)-float row per sample from the packed
    cell-corner view of the level's (res+1)^3 vertex table;
  - 'hash' (and 'tiled') levels gather 8 vertex rows per sample, with the
    instant-NGP XOR-prime hash of the corner coordinates;
  - 'cellhash' levels gather one (8F)-float row per sample, hashed from
    the cell coordinates.

The backward (`_EncodeFrozenPos`) is the gather's transpose: one row
scatter-add per level (ops/scatter_rows.py, the CUDA kernel on the card)
in place of the JAX package's sort + compensated cumsum. Positions get a
zero cotangent: sample positions are constants of the render path.

Hash products are taken in int64 and masked to 32 bits before the
modulus, which reproduces the JAX package's wrapping uint32 arithmetic.
"""

import math

import numpy as np
import torch

from ..ops import corner_sum, gather_rows, scatter_rows
from ..utils.device import constant

_HASH_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# the 8 cell-corner offsets (dx, dy, dz), in the JAX package's order
_CORNER_OFFSETS = np.stack(
    np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
).reshape(8, 3).astype(np.int64)


def level_resolutions(n_levels, base_resolution, per_level_scale):
    return [
        int(math.floor(base_resolution * per_level_scale ** level))
        for level in range(n_levels)
    ]


def grid_layout(otype, n_levels, base_resolution, per_level_scale,
                log2_hashmap_size, cellhash_min_load=None):
    """Static per-level layout [(resolution, table_size, offset, mode)] and
    the total table row count (see the JAX package for the modes)."""
    if otype not in ("HashGrid", "DenseGrid", "TiledGrid", "CellHashGrid",
                     "HybridHashGrid"):
        raise ValueError(f"unknown grid otype {otype!r}")
    hashmap_size = 1 << log2_hashmap_size
    min_load = 8.0 if cellhash_min_load is None else float(cellhash_min_load)
    levels = []
    offset = 0
    for res in level_resolutions(n_levels, base_resolution, per_level_scale):
        n_vertices = (res + 1) ** 3
        if otype == "DenseGrid" or n_vertices <= hashmap_size:
            mode, size = "dense", n_vertices
        elif otype == "HashGrid":
            mode, size = "hash", hashmap_size
        elif otype == "CellHashGrid":
            mode, size = "cellhash", hashmap_size
        elif otype == "HybridHashGrid":
            mode = ("cellhash" if n_vertices >= min_load * hashmap_size
                    else "hash")
            size = hashmap_size
        else:
            mode, size = "tiled", hashmap_size
        size = -(-size // 128) * 128  # 128-row segment alignment
        levels.append((res, size, offset, mode))
        offset += size
    return levels, offset


def _corner_offsets(device):
    return constant(_CORNER_OFFSETS, torch.int64, device)


def _hash(x, y, z):
    """instant-NGP XOR-prime hash of int64 coordinates, as uint32 in int64."""
    return ((x * _HASH_PRIMES[0]) ^ (y * _HASH_PRIMES[1])
            ^ (z * _HASH_PRIMES[2])) & _MASK32


def _trilinear_weights(frac, corner_major=False):
    """(..., 3) in-cell fractions -> (..., 8) corner weights, or (8, ...)
    with `corner_major`."""
    upper = _corner_offsets(frac.device).bool()
    if corner_major:
        upper = upper.reshape(8, *([1] * (frac.dim() - 1)), 3)
        frac = frac[None]
    else:
        frac = frac[..., None, :]
    return torch.where(upper, frac, 1.0 - frac).prod(dim=-1)


def _clipped_cell(uc, res, dtype):
    scaled = uc * res
    cell = torch.clamp(torch.floor(scaled), 0, res - 1)
    frac = (scaled - cell).to(dtype)
    return cell.to(torch.int64), frac


def _dense_cell_index_weights(uc, res, dtype):
    """(flat cell index (N,), weights (N, 8)) for a packed dense level."""
    cell, frac = _clipped_cell(uc, res, dtype)
    flat = (cell[..., 2] * res + cell[..., 1]) * res + cell[..., 0]
    return flat, _trilinear_weights(frac)


def _cellhash_index_weights(uc, res, size, dtype):
    """(hashed cell row (N,), weights (N, 8)) for a cellhash level, whose
    segment is viewed as (size/8, 8F) rows."""
    cell, frac = _clipped_cell(uc, res, dtype)
    h = _hash(cell[..., 0], cell[..., 1], cell[..., 2]) % (size // 8)
    return h, _trilinear_weights(frac)


def _level_indices_weights(uc, res, size, offset, mode, dtype,
                           corner_major=False):
    """(table rows (N, 8), weights (N, 8)) for a 'hash'/'tiled' level;
    (8, N) each with `corner_major`."""
    scaled = uc * res
    cell = torch.floor(scaled)
    frac = (scaled - cell).to(dtype)
    offsets = _corner_offsets(uc.device)
    if corner_major:
        corners = cell.to(torch.int64)[None] + offsets[:, None, :]
    else:
        corners = cell.to(torch.int64)[..., None, :] + offsets
    corners = corners.clamp(0, res)
    x, y, z = corners.unbind(-1)
    if mode == "hash":
        idx = _hash(x, y, z) % size
    else:  # tiled
        idx = ((z * (res + 1) + y) * (res + 1) + x) % size
    return offset + idx, _trilinear_weights(frac, corner_major)


def _pack_dense_segment(segment, res):
    """((res+1)^3, F) vertex segment -> (res^3, 8F) cell-corner rows."""
    F = segment.shape[-1]
    g = segment.reshape(res + 1, res + 1, res + 1, F)  # (z, y, x, F)
    parts = [g[dz:dz + res, dy:dy + res, dx:dx + res]
             for dx, dy, dz in _CORNER_OFFSETS.tolist()]
    return torch.stack(parts, dim=-2).reshape(res ** 3, 8 * F)


def _fold_dense_segment_grad(packed_grad, res, F):
    """Transpose of `_pack_dense_segment`: (res^3, 8F) -> ((res+1)^3, F)."""
    pg = packed_grad.reshape(res, res, res, 8, F)
    vg = torch.zeros((res + 1, res + 1, res + 1, F), dtype=pg.dtype,
                     device=pg.device)
    for k, (dx, dy, dz) in enumerate(_CORNER_OFFSETS.tolist()):
        vg[dz:dz + res, dy:dy + res, dx:dx + res] += pg[..., k, :]
    return vg.reshape((res + 1) ** 3, F)


def _encode_impl(table, u, levels, compute_dtype=None):
    """(N, 3) positions -> (N, L*F) features. Each level's gather goes
    through `gather_rows` (the CUDA kernel on the card), which returns the
    gathered rows in `compute_dtype` (bfloat16 on the flagship, the values
    the JAX encode gathers from its cast table); `corner_sum` (the CUDA
    kernel on the card) sums the weighted corner rows in float32 (in the
    table's dtype when no rounding is asked for)."""
    uc = torch.clamp(u, 0.0, 1.0)
    T, F = table.shape
    acc = table.dtype if compute_dtype is None else torch.float32
    features = []
    for res, size, offset, mode in levels:
        if mode == "dense":
            # packed from the float32 table: rounding is elementwise, so
            # the gathered values equal those of a packed rounded table
            packed = _pack_dense_segment(
                table[offset:offset + (res + 1) ** 3], res)
            flat, w = _dense_cell_index_weights(uc, res, acc)
            rows = gather_rows.gather_rows(
                packed, flat.to(torch.int32), compute_dtype)
        elif mode == "cellhash":
            h, w = _cellhash_index_weights(uc, res, size, acc)
            view = table.reshape(T // 8, 8 * F)[
                offset // 8:(offset + size) // 8]
            rows = gather_rows.gather_rows(view, h.to(torch.int32),
                                           compute_dtype)
        else:
            # sample-major (N, 8): measured faster on the card than the
            # corner-major order the backward uses (gather and corner sum
            # together; PERF.md)
            idx, w = _level_indices_weights(uc, res, size, offset, mode, acc)
            rows = gather_rows.gather_rows(
                table[offset:offset + size],
                (idx - offset).reshape(-1).to(torch.int32), compute_dtype)
        # sum_k w_k * row_k in float32, reading the bf16 rows once (the
        # CUDA kernel on the card)
        features.append(corner_sum.corner_sum(rows.reshape(-1, 8, F), w))
    return torch.cat(features, dim=-1)


def table_grad(g, u, levels, table_rows):
    """Table gradient of `_encode_impl` for cotangent g (N, L*F): one row
    scatter-add per level, in g's dtype."""
    uc = torch.clamp(u, 0.0, 1.0)
    F = g.shape[-1] // len(levels)
    dt = g.dtype
    grad = torch.zeros((table_rows, F), dtype=dt, device=g.device)
    for li, (res, size, offset, mode) in enumerate(levels):
        g_level = g[:, li * F:(li + 1) * F]
        if mode == "dense":
            flat, w = _dense_cell_index_weights(uc, res, dt)
            contrib = (w[..., None] * g_level[:, None, :]).reshape(-1, 8 * F)
            packed = scatter_rows.scatter_add_rows(
                flat.to(torch.int32), contrib, res ** 3)
            n = (res + 1) ** 3
            grad[offset:offset + n] = _fold_dense_segment_grad(packed, res, F)
        elif mode == "cellhash":
            h, w = _cellhash_index_weights(uc, res, size, dt)
            contrib = (w[..., None] * g_level[:, None, :]).reshape(-1, 8 * F)
            packed = scatter_rows.scatter_add_rows(
                h.to(torch.int32), contrib, size // 8)
            grad[offset:offset + size] = packed.reshape(size, F)
        else:
            # corner-major rows: a ray's consecutive samples in one cell
            # put equal indices next to each other, which the kernel sums
            # before its atomic (sample-major, they sit 8 rows apart)
            idx, w = _level_indices_weights(uc, res, size, offset, mode, dt,
                                            corner_major=True)
            contrib = (w[..., None] * g_level[None]).reshape(-1, F)
            grad[offset:offset + size] = scatter_rows.scatter_add_rows(
                (idx - offset).reshape(-1).to(torch.int32), contrib, size)
    return grad


class _EncodeFrozenPos(torch.autograd.Function):
    """Encode with the scatter-add table backward and a zero position
    cotangent (the JAX package's `_encode_frozen_pos`)."""

    @staticmethod
    def forward(ctx, table, u, levels, compute_dtype):
        ctx.save_for_backward(u)
        ctx.levels = levels
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return _encode_impl(table, u, levels, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        grad_table = None
        if ctx.needs_input_grad[0]:
            grad_table = table_grad(
                g.contiguous(), u, ctx.levels, ctx.table_shape[0]
            ).to(ctx.table_dtype)
        grad_u = torch.zeros_like(u) if ctx.needs_input_grad[1] else None
        return grad_table, grad_u, None, None


def encode(table, u, levels, compute_dtype=None):
    """Multi-resolution grid encode, with the scatter-add table backward
    and a zero position cotangent (the JAX package's
    `differentiable_positions=False`, the only mode its render path uses).

    Args:
        table: (total_table_size, F) feature table.
        u: (..., 3) positions in the contracted unit cube (clamped).
        levels: layout from `grid_layout`.
        compute_dtype: optional dtype (torch.bfloat16) the gathered table
            values are rounded to; the table gradient stays float32.
    Returns:
        (..., n_levels * F) features.
    """
    out = _EncodeFrozenPos.apply(table, u.reshape(-1, 3), tuple(levels),
                                 compute_dtype)
    return out.reshape(*u.shape[:-1], out.shape[-1])
