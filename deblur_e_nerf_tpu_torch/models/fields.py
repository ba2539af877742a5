"""Radiance fields (counterpart of deblur_e_nerf_tpu/models/fields.py):
`Dense`, `WeightNormDense`, the skip-connection `MLP`, the instant-NGP
`NGPField` and the vanilla-NeRF `VanillaNeRFField`.

Weights start as torch.nn.Linear's defaults (U(+-1/sqrt(fan_in)) for the
weight and the bias), drawn from an explicit `torch.Generator`. Layer names
follow the JAX package (`hidden_{i}`, `output`, `mlp_base`, `mlp_head`,
`table`, `base`, `sigma_layer`, `bottleneck_layer`, `rgb_layer`), so
`convert.params_from_jax` maps parameters one to one.

Each field is `encode` (positions -> the tensors the rest reads: the grid
features for NGPField, the sinusoidal encoding for the vanilla field, and
the in-aabb selector) followed by `decode` (those tensors and the view
directions -> radiance, density). The chunked training render keeps each
chunk's `encode` output for the backward and recomputes only `decode`
(models/renderer.py).
"""

import math
from typing import Optional, Tuple

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


class WeightNormDense(nn.Module):
    """Weight-normalized dense layer, as the JAX package's `Dense` with
    `weight_norm`: w = v / max(|v|, 1e-12) * g over output rows, with `v`
    drawn as nn.Linear's weight and `g` initialized to the rows' norms."""

    def __init__(self, in_features, out_features, generator=None,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.v = nn.Parameter(torch.empty((out_features, in_features),
                                          device=device))
        self.g = nn.Parameter(torch.empty(out_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.in_features) \
            if self.in_features > 0 else 0.0
        with torch.no_grad():
            for p in (self.v, self.bias):
                p.uniform_(-bound, bound, generator=generator)
            self.g.copy_(torch.linalg.vector_norm(self.v, dim=1))

    def forward(self, x):
        norm = torch.linalg.vector_norm(self.v, dim=1, keepdim=True)
        w = self.v / torch.clamp(norm, min=1e-12) * self.g[:, None]
        return nn.functional.linear(x, w, self.bias)


def dense(in_features, out_features, weight_norm=False, generator=None,
          device=None):
    cls = WeightNormDense if weight_norm else Dense
    return cls(in_features, out_features, generator, device)


class MLP(nn.Module):
    """`net_depth` hidden layers (the layer input is concatenated back after
    every `skip_layer`-th one but the first), then `output` unless
    `output_enabled` is False; `out_features` is the width it returns."""

    def __init__(self, input_dim, output_dim, net_depth, net_width,
                 hidden_activation, output_activation=None,
                 weight_norm=False, skip_layer: Optional[int] = None,
                 output_enabled=True, generator=None, device=None):
        super().__init__()
        self.net_depth = net_depth
        self.hidden_activation = hidden_activation
        self.output_activation = output_activation
        self.skip_layer = skip_layer
        width_in = input_dim
        for i in range(net_depth):
            self.add_module(f"hidden_{i}", dense(
                width_in, net_width, weight_norm, generator, device))
            width_in = net_width + (input_dim if self._skips(i) else 0)
        self.output = (dense(width_in, output_dim, weight_norm, generator,
                             device) if output_enabled else None)
        self.out_features = output_dim if output_enabled else width_in

    def _skips(self, i):
        return (self.skip_layer is not None and i % self.skip_layer == 0
                and i > 0)

    def forward(self, x):
        inputs = x
        for i in range(self.net_depth):
            x = self.hidden_activation(getattr(self, f"hidden_{i}")(x))
            if self._skips(i):
                x = torch.cat([x, inputs], dim=-1)
        if self.output is None:
            return x
        x = self.output(x)
        if self.output_activation is not None:
            x = self.output_activation(x)
        return x


def _reset_dense_layers(module, generator):
    for m in module.modules():
        if isinstance(m, (Dense, WeightNormDense)):
            m.reset_parameters(generator)


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
        _reset_dense_layers(self, generator)

    def _contract(self, x):
        u = contraction_lib.contract(x, self.aabb, self.contraction_type)
        selector = torch.all((u > 0.0) & (u < 1.0), dim=-1)
        return u, selector

    def encode(self, x, level_mask=None):
        """(features (N, L*F), in-aabb selector (N,)): the grid encode, the
        part of the field the chunked render keeps for the backward.
        `level_mask`: optional (n_levels,) 0/1 weights on the grid levels
        (the coarse-to-fine curriculum); masked levels give zero features
        and zero table gradient."""
        u, selector = self._contract(x)
        feat = hash_encoding.encode(self.table, u, self.levels,
                                    compute_dtype=self.compute_dtype)
        if level_mask is not None:
            feat = feat * torch.repeat_interleave(
                level_mask.to(feat.dtype), self.n_features_per_level)
        return feat, selector

    def _density_geo(self, feat, selector):
        h = self.mlp_base(feat)
        raw_density, geo_feat = h[..., :1], h[..., 1:]
        density = self._density_activation(raw_density) * selector[..., None]
        return density, geo_feat

    def decode(self, feat, selector, direction):
        """(radiance, density) from `encode`'s output."""
        density, geo_feat = self._density_geo(feat, selector)
        d = sh_encoding.sh_encode(direction, self.sh_degree)
        return self.mlp_head(torch.cat([d, geo_feat], dim=-1)), density

    def density(self, x, level_mask=None):
        """The density-only call (the prepass's, the occupancy update's and
        the sparsity prior's)."""
        return self._density_geo(*self.encode(x, level_mask))[0]

    def forward(self, x, direction, level_mask=None):
        return self.decode(*self.encode(x, level_mask), direction)


def _sinusoidal(x, max_deg):
    """Sinusoidal encoding with identity passthrough: [x, sin(2^i x),
    sin(2^i x + pi/2)], degree-major within each half."""
    scales = 2.0 ** torch.arange(max_deg, dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        *x.shape[:-1], max_deg * x.shape[-1])
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([x, latent], dim=-1)


class VanillaNeRFField(nn.Module):
    """Vanilla NeRF MLP field: the contracted position scaled to [-pi, pi]
    and sinusoidally encoded -> the skip MLP `base` -> `sigma_layer`
    (density) and `bottleneck_layer`; bottleneck ++ the encoded direction
    (times pi) -> `rgb_layer` -> radiance. It has no grid levels, so no
    curriculum applies (`level_mask` must be None)."""

    n_levels = 0

    def __init__(self, aabb: Tuple[float, ...],
                 contraction_type: contraction_lib.ContractionType,
                 radiance_dim=3, net_depth=8, net_width=256, skip_layer=4,
                 net_depth_condition=1, net_width_condition=128,
                 hidden_activation="softplus",
                 density_activation="shifted_trunc_exp",
                 radiance_activation="softplus", pos_encoder_max_deg=10,
                 view_encoder_max_deg=4, weight_norm=False, generator=None,
                 device=None):
        super().__init__()
        self.contraction_type = contraction_type
        self.register_buffer(
            "aabb", torch.tensor(aabb, dtype=torch.float32, device=device),
            persistent=False)
        self.pos_encoder_max_deg = pos_encoder_max_deg
        self.view_encoder_max_deg = view_encoder_max_deg
        act = activations.hidden_activation(hidden_activation)
        self.base = MLP(
            3 * (1 + 2 * pos_encoder_max_deg), 0, net_depth, net_width, act,
            weight_norm=weight_norm, skip_layer=skip_layer,
            output_enabled=False, generator=generator, device=device)
        width = self.base.out_features
        self.sigma_layer = dense(width, 1, weight_norm, generator, device)
        self.bottleneck_layer = dense(width, net_width, weight_norm,
                                      generator, device)
        self.rgb_layer = MLP(
            net_width + 3 * (1 + 2 * view_encoder_max_deg), radiance_dim,
            net_depth_condition, net_width_condition, act,
            weight_norm=weight_norm, generator=generator, device=device)
        self._density_activation = activations.density_activation(
            density_activation)
        self._radiance_activation = activations.radiance_activation(
            radiance_activation)

    def reset_parameters(self, generator=None):
        _reset_dense_layers(self, generator)

    def encode(self, x, level_mask=None):
        """(sinusoidal encoding of the [-pi, pi]-scaled contracted
        position, in-aabb selector (N,))."""
        if level_mask is not None:
            raise ValueError("the vanilla NeRF field has no grid levels to "
                             "mask")
        u = contraction_lib.contract(x, self.aabb, self.contraction_type)
        selector = torch.all((u > 0.0) & (u < 1.0), dim=-1)
        return _sinusoidal(2 * math.pi * (u - 0.5),
                           self.pos_encoder_max_deg), selector

    def _density_h(self, enc, selector):
        h = self.base(enc)
        density = self._density_activation(self.sigma_layer(h)) \
            * selector[..., None]
        return density, h

    def decode(self, enc, selector, direction):
        density, h = self._density_h(enc, selector)
        cond = _sinusoidal(direction * math.pi, self.view_encoder_max_deg)
        raw_rgb = self.rgb_layer(torch.cat([self.bottleneck_layer(h), cond],
                                           dim=-1))
        return self._radiance_activation(raw_rgb), density

    def density(self, x, level_mask=None):
        return self._density_h(*self.encode(x, level_mask))[0]

    def forward(self, x, direction, level_mask=None):
        return self.decode(*self.encode(x, level_mask), direction)
