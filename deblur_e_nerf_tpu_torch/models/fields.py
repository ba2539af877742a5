"""Radiance fields (counterpart of deblur_e_nerf_tpu/models/fields.py):
`Dense`, `MLP` and the instant-NGP `NGPField`.

Weights start as torch.nn.Linear's defaults (U(+-1/sqrt(fan_in)) for the
weight and the bias), drawn from an explicit `torch.Generator`. Layer names
follow the JAX package (`hidden_{i}`, `output`, `mlp_base`, `mlp_head`,
`table`), so `convert.params_from_jax` maps parameters one to one. The
vanilla-NeRF MLP field is still to be ported (ROADMAP Queue A 12).
"""

import math
from typing import Tuple

import torch
from torch import nn

from ..ops import activations
from . import contraction as contraction_lib
from . import hash_encoding, sh_encoding


class Dense(nn.Linear):
    """nn.Linear with torch's default init drawn from a given generator."""

    def __init__(self, in_features, out_features, generator=None,
                 device=None):
        super().__init__(in_features, out_features, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.in_features) \
            if self.in_features > 0 else 0.0
        with torch.no_grad():
            for p in (self.weight, self.bias):
                p.uniform_(-bound, bound, generator=generator)


class MLP(nn.Module):
    """`net_depth` hidden layers then `output` (the NGP MLPs have no skip
    connection; the vanilla-NeRF skip MLP waits with its field)."""

    def __init__(self, input_dim, output_dim, net_depth, net_width,
                 hidden_activation, output_activation=None,
                 weight_norm=False, generator=None, device=None):
        super().__init__()
        if weight_norm:
            raise NotImplementedError(
                "weight_norm MLPs are not ported yet (ROADMAP Queue A 12)")
        self.net_depth = net_depth
        self.hidden_activation = hidden_activation
        self.output_activation = output_activation
        width_in = input_dim
        for i in range(net_depth):
            self.add_module(f"hidden_{i}", Dense(
                width_in, net_width, generator, device))
            width_in = net_width
        self.output = Dense(width_in, output_dim, generator, device)

    def forward(self, x):
        for i in range(self.net_depth):
            x = self.hidden_activation(getattr(self, f"hidden_{i}")(x))
        x = self.output(x)
        if self.output_activation is not None:
            x = self.output_activation(x)
        return x


class NGPField(nn.Module):
    """Instant-NGP radiance field.

    Density branch: contracted position -> grid encode -> mlp_base
    (1 hidden x 64) -> [raw density | geo features]; density through the
    configured activation, gated by the in-unit-cube selector.
    View branch: SH(dir) ++ geo features -> mlp_head (2 x 64) -> radiance.
    """

    def __init__(self, aabb: Tuple[float, ...],
                 contraction_type: contraction_lib.ContractionType,
                 radiance_dim=3, pos_otype="HashGrid",
                 n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                 base_resolution=16, per_level_scale=1.4472692012786865,
                 cellhash_min_load=8.0, grid_compute_dtype="float32",
                 sh_degree=4, base_hidden_activation="softplus",
                 density_activation="shifted_trunc_exp", base_n_neurons=64,
                 base_n_hidden_layers=1, geo_feat_dim=15,
                 base_weight_norm=False, head_hidden_activation="softplus",
                 radiance_activation="softplus", head_n_neurons=64,
                 head_n_hidden_layers=2, head_weight_norm=False,
                 generator=None, device=None):
        super().__init__()
        self.contraction_type = contraction_type
        self.register_buffer(
            "aabb", torch.tensor(aabb, dtype=torch.float32, device=device),
            persistent=False)
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.sh_degree = sh_degree
        self.compute_dtype = (None if grid_compute_dtype == "float32"
                              else getattr(torch, grid_compute_dtype))
        self.levels, total_size = hash_encoding.grid_layout(
            pos_otype, n_levels, base_resolution, per_level_scale,
            log2_hashmap_size, cellhash_min_load=cellhash_min_load,
        )
        self.table = nn.Parameter(torch.empty(
            (total_size, n_features_per_level), dtype=torch.float32,
            device=device))
        self.mlp_base = MLP(
            n_levels * n_features_per_level, 1 + geo_feat_dim,
            base_n_hidden_layers, base_n_neurons,
            hidden_activation=activations.hidden_activation(
                base_hidden_activation),
            weight_norm=base_weight_norm, generator=generator, device=device,
        )
        head_in = sh_degree ** 2 + geo_feat_dim
        self.mlp_head = MLP(
            head_in, radiance_dim, head_n_hidden_layers, head_n_neurons,
            hidden_activation=activations.hidden_activation(
                head_hidden_activation),
            output_activation=activations.radiance_activation(
                radiance_activation),
            weight_norm=head_weight_norm, generator=generator, device=device,
        )
        self._density_activation = activations.density_activation(
            density_activation)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Table ~ U(-1e-4, 1e-4); MLP layers as torch.nn.Linear."""
        with torch.no_grad():
            self.table.uniform_(0.0, 2e-4, generator=generator).sub_(1e-4)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def _contract(self, x):
        u = contraction_lib.contract(x, self.aabb, self.contraction_type)
        selector = torch.all((u > 0.0) & (u < 1.0), dim=-1)
        return u, selector

    def density(self, x, return_feat=False, level_mask=None):
        """`level_mask`: optional (n_levels,) 0/1 weights on the grid levels
        (the coarse-to-fine curriculum); masked levels give zero features
        and zero table gradient."""
        u, selector = self._contract(x)
        feat = hash_encoding.encode(self.table, u, self.levels,
                                    compute_dtype=self.compute_dtype)
        if level_mask is not None:
            feat = feat * torch.repeat_interleave(
                level_mask.to(feat.dtype), self.n_features_per_level)
        h = self.mlp_base(feat)
        raw_density, geo_feat = h[..., :1], h[..., 1:]
        density = self._density_activation(raw_density) * selector[..., None]
        if return_feat:
            return density, geo_feat
        return density

    def forward(self, x, direction, level_mask=None):
        density, geo_feat = self.density(x, return_feat=True,
                                         level_mask=level_mask)
        d = sh_encoding.sh_encode(direction, self.sh_degree)
        return self.mlp_head(torch.cat([d, geo_feat], dim=-1)), density
