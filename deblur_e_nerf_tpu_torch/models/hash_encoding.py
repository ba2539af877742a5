"""Multi-resolution grid encodings (counterpart of
deblur_e_nerf_tpu/models/hash_encoding.py).

Same level geometry and table layout as the JAX package (`grid_layout`,
including the 128-row segment alignment), so tables move between the two
packages unchanged. The encode is one call per direction over all levels
(`ops/hash_encode.py`, a fused CUDA kernel each on the card):

  - the forward finds each sample's cell at every level, reads the 8
    corner rows ('dense' levels: the (res+1)^3 vertex rows; 'hash' and
    'tiled' levels: the instant-NGP XOR-prime hash or the flat vertex
    index of each corner; 'cellhash' levels: one (8F)-float row hashed
    from the cell), rounds them to `compute_dtype` (bfloat16 on the
    flagship: on the card the kernel reads a bf16 copy of the table, made
    once per change of the table) and interpolates trilinearly in
    float32, writing (N, L*F);
  - the backward (`_EncodeFrozenPos`) adds each w * g into the rows it
    read, in float32, in place of the JAX package's sort + compensated
    cumsum. Positions get a zero cotangent: sample positions are
    constants of the render path.
"""

import math

import torch

from ..ops import hash_encode


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


def _encode_impl(table, u, levels, compute_dtype=None):
    """(N, 3) positions -> (N, L*F) features (`hash_encode.encode_forward`:
    one kernel launch on the card)."""
    return hash_encode.encode_forward(table, u, levels, compute_dtype)


class _EncodeFrozenPos(torch.autograd.Function):
    """Encode with the row-sum table backward and a zero position
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
            # one kernel launch on the card
            grad_table = hash_encode.encode_backward(
                g.contiguous(), u, ctx.levels, ctx.table_shape[0]
            ).to(ctx.table_dtype)
        grad_u = torch.zeros_like(u) if ctx.needs_input_grad[1] else None
        return grad_table, grad_u, None, None


def encode(table, u, levels, compute_dtype=None):
    """Multi-resolution grid encode, with the row-sum table backward
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
    out = _EncodeFrozenPos.apply(table, u.reshape(-1, 3).contiguous(),
                                 tuple(levels),
                                 compute_dtype)
    return out.reshape(*u.shape[:-1], out.shape[-1])
