"""Stable stream compaction of flagged lanes into fixed-size buffers
(counterpart of the JAX package's `_compact` and the occlusion prepass's
`put`, deblur_e_nerf_tpu/models/renderer.py:196 and :523).

  - `compact(flags, payloads, budget, fills, return_cutoff=False)` ->
    (buffers, total[, cutoff]): each payload's flagged lanes, in lane
    order, in the first slots of a (budget + 1,) buffer whose other slots
    hold the payload's fill (slot `budget` always does); lanes past the
    budget are dropped. `total` is the number of flagged lanes, and
    `cutoff` the smallest payload of channel 0 among the dropped lanes
    (its fill when none was), both () int64 device tensors: nothing is
    read back to the host. On a CUDA tensor it launches the kernels of
    `csrc/compact.cu` (one to three int64 or float32 channels in one
    launch) or raises; on a CPU tensor it runs `compact_reference`.
  - `compact_reference`: the plain version (the march's former
    `_compact` and the prepass's `put`: a cumsum of the flags and a
    scatter to its positions, dropped lanes into a discarded slot).

`LAUNCHES` counts the wrapper's kernel launches.
"""

import struct

import torch

LAUNCHES = 0  # kernel launches since the last reset (plain int)

MAX_CHANNELS = 3
TILE = 4096  # lanes a block of the kernels (csrc/compact.cu kTile)

_launch = None  # the kernel library's C entry point, bound at first use


def compact_reference(flags, payloads, budget, fills, return_cutoff=False):
    """Plain version: (list of (budget + 1,) buffers, total[, cutoff])."""
    flags = flags.reshape(-1)
    csum = torch.cumsum(flags.to(torch.int64), dim=0)
    keep = flags & (csum <= budget)
    # overflow lanes land in a discarded extra slot budget + 1
    write_idx = torch.where(keep, csum - 1, torch.full_like(csum, budget + 1))

    def put(payload, fill):
        buf = torch.full((budget + 2,), fill, dtype=payload.dtype,
                         device=payload.device)
        buf[write_idx] = payload.reshape(-1)
        return buf[:budget + 1]

    bufs = [put(p, f) for p, f in zip(payloads, fills)]
    total = csum[-1]
    if return_cutoff:
        payload = payloads[0].reshape(-1)
        dropped = torch.where(flags & (csum > budget), payload,
                              torch.full_like(payload, fills[0]))
        return bufs, total, dropped.min()
    return bufs, total


def _fill_bits(value, dtype):
    """The fill's bits as the kernel writes them: the march's int64 codes
    and the prepass's float32 t_mid and dt and int64 ray ids."""
    if dtype == torch.int64:
        return int(value) & 0xFFFFFFFFFFFFFFFF
    if dtype == torch.float32:
        return struct.unpack("<I", struct.pack("<f", float(value)))[0]
    raise TypeError(f"the kernel takes int64 and float32 payloads, got "
                    f"{dtype}")


def _bind():
    global _launch
    from . import _cuda_build

    _launch = _cuda_build.library().compact_launch
    return _launch


def compact(flags, payloads, budget, fills, return_cutoff=False):
    """Stream-compact each of `payloads` (sequences of tensors with the
    flags' lane count) by `flags` into (budget + 1,) buffers; see the
    module docstring. `fills` gives each payload's fill value."""
    global LAUNCHES
    payloads, fills, budget = list(payloads), list(fills), int(budget)
    if not 1 <= len(payloads) <= MAX_CHANNELS \
            or len(fills) != len(payloads):
        raise ValueError(f"expected 1-{MAX_CHANNELS} payloads with a fill "
                         f"each, got {len(payloads)} and {len(fills)}")
    n = flags.numel()
    if any(p.numel() != n for p in payloads):
        raise ValueError(f"payloads of {[p.numel() for p in payloads]} "
                         f"lanes for {n} flags")
    if flags.dtype != torch.bool:
        raise TypeError(f"flags must be bool, got {flags.dtype}")
    if budget < 0 or n == 0:
        raise ValueError(f"budget {budget} and {n} lanes: need a budget "
                         f">= 0 and at least one lane")
    if return_cutoff and payloads[0].dtype != torch.int64:
        raise TypeError("the cutoff is taken of an int64 payload")
    if not flags.is_cuda:
        if flags.device.type != "cpu" or any(p.device != flags.device
                                             for p in payloads):
            raise ValueError(f"flags on {flags.device}, payloads on "
                             f"{[str(p.device) for p in payloads]}")
        return compact_reference(flags, payloads, budget, fills,
                                 return_cutoff)
    device = flags.device
    if any(p.device != device for p in payloads):
        raise ValueError(f"flags on {device}, payloads on "
                         f"{[str(p.device) for p in payloads]}")
    if not (flags.is_contiguous() and all(p.is_contiguous()
                                          for p in payloads)):
        raise ValueError("flags and payloads must be contiguous")
    bits = [_fill_bits(f, p.dtype) for p, f in zip(payloads, fills)]
    bufs = [torch.empty(budget + 1, dtype=p.dtype, device=device)
            for p in payloads]
    tiles = torch.empty(-(-n // TILE), dtype=torch.int64, device=device)
    total = torch.empty((), dtype=torch.int64, device=device)
    cutoff = (torch.empty((), dtype=torch.int64, device=device)
              if return_cutoff else None)
    pad = MAX_CHANNELS - len(payloads)
    src = [p.data_ptr() for p in payloads] + [None] * pad
    dst = [b.data_ptr() for b in bufs] + [None] * pad
    sizes = [p.element_size() for p in payloads] + [0] * pad
    bits += [0] * pad
    launch = _launch or _bind()
    with torch.cuda.device(device):
        err = launch(flags.data_ptr(), n, len(payloads), *src, *dst, *sizes,
                     *bits, budget, tiles.data_ptr(), total.data_ptr(),
                     None if cutoff is None else cutoff.data_ptr(),
                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compact_launch failed: CUDA error {err}")
    LAUNCHES += 1
    if return_cutoff:
        return bufs, total, cutoff
    return bufs, total
