"""The multi-resolution grid encode over all levels, one call per direction
(counterpart of the JAX package's custom-VJP encode,
deblur_e_nerf_tpu/models/hash_encoding.py `_encode_frozen_pos`, :372-555):

  - `encode_forward(table, u, levels, compute_dtype)` -> (N, L*F) features,
    for JAX `_encode_impl` (:332-369);
  - `encode_backward(g, u, levels, table_rows)` -> the (T, F) table
    gradient, for JAX `_encode_frozen_pos_bwd` (:420-552).

Neither replaces a Pallas kernel: the JAX package writes the encode as
plain array code that XLA compiles. On a CUDA tensor each launches its
hand-written kernel in `csrc/hash_encode.cu` (one launch over all levels;
see the note there for what bounds it) or raises; it never falls back. On
a CPU tensor each runs its plain PyTorch version
(`encode_forward_reference`, `encode_backward_reference`).
`encode_forward_model` is the plain model of the forward kernel's
summation order (corners in order, no fused multiply-add): the card tests
hold the kernel to it bit for bit. `backward_reductions` counts the
reductions the backward kernel issues (its model of combining by row or
cell, and of pairing). `FORWARD_LAUNCHES` and `BACKWARD_LAUNCHES` count
kernel launches.

The forward in bf16 (compute_dtype torch.bfloat16) reads a bf16 copy of
the table on the card, `table.to(torch.bfloat16)`: the values the kernel
once rounded after each load, bit for bit. `bf16_table` makes it once per
change of the table (its autograd version counter, which every in-place
write moves: the optimizer's update, `load_state_dict`) and keeps one
copy; `BF16_COPIES` counts the copies made.

Per level and sample, `level_rows_weights` gives the 8 table rows of the
cell's corners and their trilinear weights (the same rows and weights the
kernels compute):
  - 'dense' levels read the (res+1)^3 vertex rows of the cell's corners
    (the cell clipped to [0, res - 1]);
  - 'hash' ('tiled') levels the instant-NGP XOR-prime hash (the flat
    vertex index) of each corner, clipped to [0, res], mod the level size;
  - 'cellhash' levels one (8F)-float row of the level's segment, hashed
    from the cell's coordinates: corner k is its row's k-th F floats.
Hash products are taken in int64 and masked to 32 bits before the
modulus, which reproduces the JAX package's wrapping uint32 arithmetic.
"""

import ctypes
import functools
import weakref

import numpy as np
import torch

from ..utils.device import constant

FORWARD_LAUNCHES = 0   # forward kernel launches since the last reset
BACKWARD_LAUNCHES = 0  # backward kernel launches since the last reset
BF16_COPIES = 0        # bf16 table copies made since the last reset

MAX_LEVELS = 32      # the kernels' level parameters hold this many
KERNEL_FEATURES = 2  # features a level in the kernels (every config's)
MODES = {"dense": 0, "hash": 1, "tiled": 2, "cellhash": 3}

_HASH_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# the 8 cell-corner offsets (dx, dy, dz), in the JAX package's order:
# corner k = 4 dx + 2 dy + dz
CORNER_OFFSETS = np.stack(
    np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
).reshape(8, 3).astype(np.int64)


def _hash(x, y, z):
    """instant-NGP XOR-prime hash of int64 coordinates, as uint32 in int64."""
    return ((x * _HASH_PRIMES[0]) ^ (y * _HASH_PRIMES[1])
            ^ (z * _HASH_PRIMES[2])) & _MASK32


def _weights(frac):
    """(N, 3) in-cell fractions -> (N, 8) corner weights, each the product
    (w_x * w_y) * w_z, w = frac for the upper corner and 1 - frac for the
    lower (the kernels' order)."""
    per_axis = torch.stack([1.0 - frac, frac], dim=-1)  # (N, 3, 2)
    upper = CORNER_OFFSETS.tolist()
    return torch.stack([per_axis[:, 0, dx] * per_axis[:, 1, dy]
                        * per_axis[:, 2, dz] for dx, dy, dz in upper], dim=-1)


def level_rows_weights(uc, res, size, offset, mode, dtype):
    """(table rows (N, 8) int64, weights (N, 8) in `dtype`) of one level,
    for positions uc (N, 3) already clipped to [0, 1]."""
    scaled = uc * res
    cell = torch.floor(scaled)
    if mode in ("dense", "cellhash"):
        cell = torch.clamp(cell, 0, res - 1)
    frac = (scaled - cell).to(dtype)
    cell = cell.to(torch.int64)
    w = _weights(frac)
    if mode == "cellhash":
        h = _hash(cell[:, 0], cell[:, 1], cell[:, 2]) % (size // 8)
        k = torch.arange(8, device=uc.device)
        return offset + 8 * h[:, None] + k, w
    corners = cell[:, None, :] + constant(CORNER_OFFSETS, torch.int64,
                                          uc.device)
    x, y, z = corners.unbind(-1)
    if mode == "dense":
        return offset + (z * (res + 1) + y) * (res + 1) + x, w
    x, y, z = (c.clamp(0, res) for c in (x, y, z))
    if mode == "hash":
        return offset + _hash(x, y, z) % size, w
    flat = ((z * (res + 1) + y) * (res + 1) + x) & _MASK32  # tiled
    return offset + flat % size, w


def _corner_values(table, rows, compute_dtype, acc):
    """The (N, 8, F) corner rows, rounded to `compute_dtype` when given,
    in the accumulation dtype."""
    values = table.index_select(0, rows.reshape(-1)).reshape(
        *rows.shape, table.shape[1])
    if compute_dtype is not None:
        values = values.to(compute_dtype)
    return values.to(acc)


def _accumulation_dtype(table, compute_dtype):
    # float64 for a float64 table with no rounding asked for (the
    # exactness tests), float32 otherwise (a bf16 table included)
    if compute_dtype is None and table.dtype == torch.float64:
        return torch.float64
    return torch.float32


def encode_forward_reference(table, u, levels, compute_dtype=None):
    """Plain PyTorch version of the forward: per level, the 8 corner rows
    gathered (rounded to `compute_dtype` when given) and summed with their
    weights over the corners."""
    uc = torch.clamp(u, 0.0, 1.0)
    acc = _accumulation_dtype(table, compute_dtype)
    features = []
    for level in levels:
        rows, w = level_rows_weights(uc, *level, acc)
        values = _corner_values(table, rows, compute_dtype, acc)
        features.append(torch.sum(values * w[..., None], dim=1))
    return torch.cat(features, dim=-1)


def encode_forward_model(table, u, levels, compute_dtype=None):
    """The forward kernel's order: each corner's product rounded, then
    summed over k = 0..7 one at a time."""
    uc = torch.clamp(u, 0.0, 1.0)
    acc = _accumulation_dtype(table, compute_dtype)
    features = []
    for level in levels:
        rows, w = level_rows_weights(uc, *level, acc)
        prod = _corner_values(table, rows, compute_dtype, acc) * w[..., None]
        total = prod[:, 0]
        for k in range(1, 8):
            total = total + prod[:, k]
        features.append(total)
    return torch.cat(features, dim=-1)


def encode_backward_reference(g, u, levels, table_rows, sum_dtype=None):
    """Plain PyTorch version of the backward: each w * g contribution (in
    g's dtype) index_add_-ed into a zero (table_rows, F) table of
    `sum_dtype` (default g's dtype; float64 for exactness checks)."""
    uc = torch.clamp(u, 0.0, 1.0)
    F = g.shape[-1] // len(levels)
    grad = torch.zeros((int(table_rows), F), dtype=sum_dtype or g.dtype,
                       device=g.device)
    for li, level in enumerate(levels):
        rows, w = level_rows_weights(uc, *level, g.dtype)
        contrib = w[..., None] * g[:, None, li * F:(li + 1) * F]
        grad.index_add_(0, rows.reshape(-1), contrib.reshape(-1, F)
                        .to(grad.dtype))
    return grad


def x_pairs(rows):
    """(N, 4) bool: whether corners k and k + 4 (the x-neighbours) of each
    sample lie in one aligned pair of rows (2 i, 2 i + 1), which the
    kernels read with one load and reduce with one F32x4: row_k // 2 ==
    row_{k+4} // 2, for `rows` (N, 8) of `level_rows_weights`."""
    return (rows[:, :4] >> 1) == (rows[:, 4:] >> 1)


def _groups(key, mask):
    """Distinct keys among the masked entries."""
    return torch.unique(key[mask]).numel()


def _level_cells(uc, res, mode):
    """(N,) int64 id of each sample's cell at one level (the cell the
    kernels key a vertex level's combining on: clipped on dense levels,
    unclipped on hash and tiled ones)."""
    cell = torch.floor(uc * res)
    if mode == "dense":
        cell = torch.clamp(cell, 0, res - 1)
    cell = cell.to(torch.int64)
    return cell[:, 0] | (cell[:, 1] << 21) | (cell[:, 2] << 42)


def backward_reductions(g, u, levels):
    """The reductions the backward kernel issues for cotangent g (N, L*F)
    at positions u (N, 3), by level mode: {mode: {"x2": RED.F32x2,
    "x4": RED.F32x4, "bulk64": 64-byte bulk reductions}}.

    The kernel's rules: a warp holds 32 consecutive samples of one level;
    a sample with an all-zero cotangent adds nothing; the lanes that share
    a target combine into one lane, which issues where its contribution is
    not all zero (products w * g in float32, as the kernel forms them; a
    sum that cancels to exactly zero is counted). On a cellhash level the
    target is the row: one bulk reduction. On a vertex level it is the
    cell (its 8 rows); per corner pair k < 4, where `x_pairs` holds one
    F32x4 if both rows of the unit receive a non-zero contribution and
    one F32x2 if one does (or if the two corners are one clipped row),
    otherwise one F32x2 for each row that receives one."""
    uc = torch.clamp(u, 0.0, 1.0)
    n = u.shape[0]
    F = g.shape[-1] // len(levels)
    warp = torch.arange(n, device=u.device) // 32
    counts = {}
    for li, level in enumerate(levels):
        res, _, _, mode = level
        gl = g[:, li * F:(li + 1) * F]
        live = (gl != 0).any(-1)
        rows, w = level_rows_weights(uc, *level, g.dtype)
        nz = ((w[..., None] * gl[:, None]) != 0).any(-1) & live[:, None]
        c = counts.setdefault(mode, {"x2": 0, "x4": 0, "bulk64": 0})
        if mode == "cellhash":
            c["bulk64"] += _groups(warp * (1 << 32) + rows[:, 0],
                                   nz.any(-1))
            continue
        # (warp, cell) as one int64: the cells numbered in order
        cells = torch.unique(_level_cells(uc, res, mode),
                             return_inverse=True)[1]
        group = warp * n + cells
        paired = x_pairs(rows)
        for k in range(4):
            a, b, p = nz[:, k], nz[:, k + 4], paired[:, k]
            one_row = rows[:, k] == rows[:, k + 4]
            two = p & ~one_row  # two rows of one unit
            either = _groups(group, (a | b) & two)
            both = _groups(group, a & two) + _groups(group, b & two) - either
            c["x4"] += both
            c["x2"] += (either - both + _groups(group, (a | b) & one_row)
                        + _groups(group, a & ~p) + _groups(group, b & ~p))
    return counts


class _LevelParams(ctypes.Structure):
    """The kernels' `Levels` struct (csrc/hash_encode.cu)."""
    _fields_ = [("n", ctypes.c_int32),
                ("mode", ctypes.c_int32 * MAX_LEVELS),
                ("res", ctypes.c_uint32 * MAX_LEVELS),
                ("size", ctypes.c_uint32 * MAX_LEVELS),
                ("offset", ctypes.c_uint32 * MAX_LEVELS)]


@functools.lru_cache(maxsize=64)
def _level_params(levels):
    params = _LevelParams()
    params.n = len(levels)
    for i, (res, size, offset, mode) in enumerate(levels):
        params.mode[i] = MODES[mode]
        params.res[i], params.size[i], params.offset[i] = res, size, offset
    return params


@functools.lru_cache(maxsize=64)
def _check_levels(levels, table_rows):
    """The layout's own checks (grid_layout builds every layout so)."""
    if not levels:
        raise ValueError("no levels")
    for res, size, offset, mode in levels:
        if mode not in MODES:
            raise ValueError(f"unknown level mode {mode!r}")
        if res < 1 or size < 1 or offset < 0 or offset + size > table_rows:
            raise ValueError(f"level {(res, size, offset, mode)} does not "
                             f"fit a table of {table_rows} rows")
        if mode == "dense" and (res + 1) ** 3 > size:
            raise ValueError(f"dense level {(res, size, offset)}: "
                             f"{(res + 1) ** 3} vertices in {size} rows")
        if mode == "cellhash" and (size % 8 or offset % 8):
            raise ValueError(f"cellhash level {(res, size, offset)}: size "
                             f"and offset must be multiples of 8 rows")


def _check(table_rows, u, levels, width, width_name):
    if u.dim() != 2 or u.shape[1] != 3:
        raise ValueError(f"expected u (N, 3), got {tuple(u.shape)}")
    if width % len(levels):
        raise ValueError(f"{width_name} {width} is not a multiple of "
                         f"{len(levels)} levels")
    _check_levels(tuple(levels), int(table_rows))


@functools.lru_cache(maxsize=64)
def _check_card_levels(levels):
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"the CUDA kernel takes at most {MAX_LEVELS} "
                         f"levels, got {len(levels)}")
    if any(res >= 1 << 21 for res, *_ in levels):  # 21-bit cell keys
        raise ValueError(f"the CUDA kernel takes resolutions below 2^21, "
                         f"got {max(res for res, *_ in levels)}")


def _check_card(tensors, levels, features, table_rows):
    """The kernels' own limits, on the card."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if features != KERNEL_FEATURES:
        raise ValueError(f"the CUDA kernel takes {KERNEL_FEATURES} features "
                         f"a level, got {features}")
    _check_card_levels(levels)
    if table_rows >= 1 << 31:  # the kernels hold rows in 32 bits
        raise ValueError(f"the CUDA kernel takes tables of fewer than 2^31 "
                         f"rows, got {table_rows}")
    if table_rows % 2:  # the kernels read and reduce aligned row pairs
        raise ValueError(f"the CUDA kernel takes an even number of table "
                         f"rows, got {table_rows}")


def _stream(device):
    return torch._C._cuda_getCurrentRawStream(device.index)


def _library():
    from . import _cuda_build

    return _cuda_build.library()


_bf16_cache = (None, -1, None)  # (the table, weakly; its version; copy)


def bf16_table(table):
    """`table.to(torch.bfloat16)`, made once per change of `table` and
    reused until the next: a change is a new tensor or a move of its
    autograd version counter (every in-place write moves it). No device
    value is read. One copy is kept."""
    global _bf16_cache, BF16_COPIES
    ref, version, copy = _bf16_cache
    if ref is None or ref() is not table or version != table._version:
        copy = table.detach().to(torch.bfloat16)
        _bf16_cache = (weakref.ref(table), table._version, copy)
        BF16_COPIES += 1
    return copy


def encode_forward(table, u, levels, compute_dtype=None):
    """Features (N, L*F) of positions u (N, 3) (clipped to [0, 1]).

    Args:
        table: (T, F) feature table, float32 or bfloat16 (float64 on the
            CPU only); on the card contiguous, 16-byte aligned, F = 2, T
            even.
        u: (N, 3) positions, float32 (a float64 table's dtype on the CPU),
            contiguous on the card.
        levels: the layout of `grid_layout`, at most 32 levels on the card.
        compute_dtype: None, or torch.bfloat16: each gathered table value
            is rounded to it (nearest even) before the float32 sum. On the
            card the kernel reads `bf16_table(table)` instead; a bf16
            table is read as it is either way.
    Returns:
        (N, L*F) in float32 (float64 for a float64 table and no
        compute_dtype).
    """
    global FORWARD_LAUNCHES
    if table.dim() != 2:
        raise ValueError(f"expected table (T, F), got {tuple(table.shape)}")
    levels = tuple(levels)
    _check(table.shape[0], u, levels, table.shape[1] * len(levels),
           "features")
    if compute_dtype not in (None, torch.bfloat16):
        raise TypeError(f"compute_dtype must be None or torch.bfloat16, got "
                        f"{compute_dtype}")
    if u.device != table.device:
        raise ValueError(f"u on {u.device}, table on {table.device}")
    if table.device.type == "cpu":
        if table.dtype not in (torch.float32, torch.float64,
                               torch.bfloat16):
            raise TypeError(f"table must be float32/64 or bfloat16, got "
                            f"{table.dtype}")
        return encode_forward_reference(table, u, levels, compute_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if compute_dtype is not None and table.dtype == torch.float32:
        table = bf16_table(table)
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes a float32 or bfloat16 "
                        f"table, got {table.dtype}")
    _check_card({"u": u}, levels, table.shape[1], table.shape[0])
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (a view at an "
                         "offset?)")
    n = u.shape[0]
    out = torch.empty((n, table.shape[1] * len(levels)), dtype=torch.float32,
                      device=table.device)
    err = _library().hash_encode_fwd(
        table.data_ptr(), u.data_ptr(), out.data_ptr(), n,
        ctypes.addressof(_level_params(levels)),
        int(table.dtype == torch.bfloat16), _stream(table.device))
    if err != 0:
        raise RuntimeError(f"hash_encode_fwd launch failed: CUDA {err}")
    FORWARD_LAUNCHES += 1
    return out


def encode_backward(g, u, levels, table_rows):
    """Table gradient (table_rows, F) of `encode_forward` for the
    cotangent g (N, L*F): the row sums of w_k * g over every sample,
    level and corner, in g's dtype (float32 on the card, where the sums
    take their order from atomics). The positions get no gradient.

    Args:
        g: (N, L*F) cotangent, float32 (float64 on the CPU only); on the
            card contiguous and 8-byte aligned, F = 2.
        u: (N, 3) positions, as given to the forward.
        levels: the forward's layout.
        table_rows: T.
    """
    global BACKWARD_LAUNCHES
    if g.dim() != 2:
        raise ValueError(f"expected g (N, L*F), got {tuple(g.shape)}")
    levels = tuple(levels)
    _check(table_rows, u, levels, g.shape[1], "cotangent width")
    if g.shape[0] != u.shape[0]:
        raise ValueError(f"g has {g.shape[0]} rows, u {u.shape[0]}")
    if u.device != g.device:
        raise ValueError(f"u on {u.device}, g on {g.device}")
    if g.device.type == "cpu":
        if g.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"g must be float32/64, got {g.dtype}")
        return encode_backward_reference(g, u, levels, table_rows)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _check_card({"g": g, "u": u}, levels, g.shape[1] // len(levels),
                int(table_rows))
    if g.data_ptr() % 8:
        raise ValueError("g must be 8-byte aligned (a view at an offset?)")
    grad = torch.empty((int(table_rows), KERNEL_FEATURES),
                       dtype=torch.float32, device=g.device)
    err = _library().hash_encode_bwd(
        g.data_ptr(), u.data_ptr(), grad.data_ptr(), g.shape[0],
        int(table_rows), ctypes.addressof(_level_params(levels)),
        _stream(g.device))
    if err != 0:
        raise RuntimeError(f"hash_encode_bwd launch failed: CUDA {err}")
    BACKWARD_LAUNCHES += 1
    return grad
