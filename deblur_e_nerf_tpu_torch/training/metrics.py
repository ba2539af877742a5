"""Image quality metrics (counterpart of deblur_e_nerf_tpu/training/metrics.py):
  - L1: channel-mean absolute error;
  - PSNR with data_range = max_target - min_target (relative metric);
  - SSIM with data_range = max_target (absolute metric), gaussian window
    11x11 sigma 1.5;
  - LPIPS (alex, vgg or squeeze) from a LOCAL state dict in the `lpips`
    package's key naming (`metric.lpips_weights_path`); there is no
    download. Without weights the metric is NaN; a net that cannot be
    built (an unknown name, a file that does not load) is NaN too, with one
    message per (net, weights path, device).

L1, PSNR and SSIM run on the host in float64; LPIPS runs on the device it
is given (the trainer's) in float32.
"""

import numpy as np


def l1(pred, target):
    """Mean absolute error over all pixels and channels."""
    return float(np.mean(np.abs(pred - target)))


def psnr(pred, target, data_range):
    """Per-image PSNR, then mean; pred/target (B, C, H, W)."""
    mse = np.mean((pred - target) ** 2, axis=(1, 2, 3))
    mse = np.maximum(mse, 1e-20)
    return float(np.mean(10 * np.log10(data_range ** 2 / mse)))


def _gaussian_kernel(size=11, sigma=1.5):
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return g


def _filter2d_valid(img, kernel1d):
    """Separable 2D convolution, valid region only (img: (..., H, W))."""
    from scipy.ndimage import convolve1d

    out = convolve1d(img, kernel1d, axis=-1, mode="constant")
    out = convolve1d(out, kernel1d, axis=-2, mode="constant")
    k = len(kernel1d) // 2
    return out[..., k:-k, k:-k]


def ssim(pred, target, data_range, kernel_size=11, sigma=1.5,
         k1=0.01, k2=0.03):
    """Mean SSIM over the valid (un-padded) region, (B, C, H, W) inputs."""
    kernel = _gaussian_kernel(kernel_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_p = _filter2d_valid(pred, kernel)
    mu_t = _filter2d_valid(target, kernel)
    mu_pp = _filter2d_valid(pred * pred, kernel)
    mu_tt = _filter2d_valid(target * target, kernel)
    mu_pt = _filter2d_valid(pred * target, kernel)

    sigma_p = mu_pp - mu_p ** 2
    sigma_t = mu_tt - mu_t ** 2
    sigma_pt = mu_pt - mu_p * mu_t

    num = (2 * mu_p * mu_t + c1) * (2 * sigma_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (sigma_p + sigma_t + c2)
    return float(np.mean(num / den))


# LPIPS backbones: (slice, [(torchvision `features` index, module spec)]),
# grouped into the lpips package's slices so that its state dicts load
# verbatim, and the channels of each tap
LPIPS_NETS = {
    "alex": ([
        (1, [(0, ("conv", 3, 64, 11, 4, 2)), (1, "relu")]),
        (2, [(2, ("maxpool", 3, 2)), (3, ("conv", 64, 192, 5, 1, 2)),
             (4, "relu")]),
        (3, [(5, ("maxpool", 3, 2)), (6, ("conv", 192, 384, 3, 1, 1)),
             (7, "relu")]),
        (4, [(8, ("conv", 384, 256, 3, 1, 1)), (9, "relu")]),
        (5, [(10, ("conv", 256, 256, 3, 1, 1)), (11, "relu")]),
    ], (64, 192, 384, 256, 256)),
    # torchvision VGG16 `features`: taps after relu1_2/2_2/3_3/4_3/5_3
    "vgg": ([
        (1, [(0, ("conv", 3, 64, 3, 1, 1)), (1, "relu"),
             (2, ("conv", 64, 64, 3, 1, 1)), (3, "relu")]),
        (2, [(4, ("maxpool", 2, 2)), (5, ("conv", 64, 128, 3, 1, 1)),
             (6, "relu"), (7, ("conv", 128, 128, 3, 1, 1)), (8, "relu")]),
        (3, [(9, ("maxpool", 2, 2)), (10, ("conv", 128, 256, 3, 1, 1)),
             (11, "relu"), (12, ("conv", 256, 256, 3, 1, 1)), (13, "relu"),
             (14, ("conv", 256, 256, 3, 1, 1)), (15, "relu")]),
        (4, [(16, ("maxpool", 2, 2)), (17, ("conv", 256, 512, 3, 1, 1)),
             (18, "relu"), (19, ("conv", 512, 512, 3, 1, 1)), (20, "relu"),
             (21, ("conv", 512, 512, 3, 1, 1)), (22, "relu")]),
        (5, [(23, ("maxpool", 2, 2)), (24, ("conv", 512, 512, 3, 1, 1)),
             (25, "relu"), (26, ("conv", 512, 512, 3, 1, 1)), (27, "relu"),
             (28, ("conv", 512, 512, 3, 1, 1)), (29, "relu")]),
    ], (64, 128, 256, 512, 512)),
    # torchvision SqueezeNet1_1 `features`, the lpips package's 7 taps
    "squeeze": ([
        (1, [(0, ("conv", 3, 64, 3, 2, 0)), (1, "relu")]),
        (2, [(2, ("ceilpool", 3, 2)), (3, ("fire", 64, 16, 64, 64)),
             (4, ("fire", 128, 16, 64, 64))]),
        (3, [(5, ("ceilpool", 3, 2)), (6, ("fire", 128, 32, 128, 128)),
             (7, ("fire", 256, 32, 128, 128))]),
        (4, [(8, ("ceilpool", 3, 2)), (9, ("fire", 256, 48, 192, 192))]),
        (5, [(10, ("fire", 384, 48, 192, 192))]),
        (6, [(11, ("fire", 384, 64, 256, 256))]),
        (7, [(12, ("fire", 512, 64, 256, 256))]),
    ], (64, 128, 256, 384, 384, 512, 512)),
}


def lpips_module(net):
    """The lpips package's `LPIPS(net=...)` module, without weights: its
    forward (`spatial=False`) is the scaling layer -> backbone taps ->
    unit-normalize over channels -> squared difference -> 1x1
    non-negative linear heads -> spatial mean -> sum over taps, and its
    state-dict keys are the package's."""
    import torch
    from torch import nn

    if net not in LPIPS_NETS:
        raise NotImplementedError(f"LPIPS backbone {net!r} (supported: "
                                  f"{sorted(LPIPS_NETS)})")
    slices, chns = LPIPS_NETS[net]

    class Fire(nn.Module):
        def __init__(self, cin, sq, e1, e3):
            super().__init__()
            self.squeeze = nn.Conv2d(cin, sq, 1)
            self.squeeze_activation = nn.ReLU(inplace=True)
            self.expand1x1 = nn.Conv2d(sq, e1, 1)
            self.expand1x1_activation = nn.ReLU(inplace=True)
            self.expand3x3 = nn.Conv2d(sq, e3, 3, padding=1)
            self.expand3x3_activation = nn.ReLU(inplace=True)

        def forward(self, x):
            x = self.squeeze_activation(self.squeeze(x))
            return torch.cat([
                self.expand1x1_activation(self.expand1x1(x)),
                self.expand3x3_activation(self.expand3x3(x))], 1)

    def make(spec):
        if spec == "relu":
            return nn.ReLU(inplace=True)
        kind, *args = spec
        if kind == "conv":
            cin, cout, k, stride, pad = args
            return nn.Conv2d(cin, cout, k, stride, pad)
        if kind == "maxpool":
            return nn.MaxPool2d(*args)
        if kind == "ceilpool":
            return nn.MaxPool2d(*args, ceil_mode=True)
        return Fire(*args)

    class Lin(nn.Module):
        def __init__(self, chn):
            super().__init__()
            self.model = nn.Sequential(nn.Dropout(),
                                       nn.Conv2d(chn, 1, 1, bias=False))

        def forward(self, x):
            return self.model(x)

    class LPIPS(nn.Module):
        def __init__(self):
            super().__init__()
            self.scaling_layer = nn.Module()
            self.scaling_layer.register_buffer("shift",
                                               torch.zeros(1, 3, 1, 1))
            self.scaling_layer.register_buffer("scale",
                                               torch.ones(1, 3, 1, 1))
            self.net = nn.Module()
            for si, mods in slices:
                seq = nn.Sequential()
                for idx, spec in mods:
                    seq.add_module(str(idx), make(spec))
                setattr(self.net, f"slice{si}", seq)
            for i, c in enumerate(chns):
                setattr(self, f"lin{i}", Lin(c))

        def forward(self, in0, in1):
            sl = self.scaling_layer
            x0, x1 = (in0 - sl.shift) / sl.scale, (in1 - sl.shift) / sl.scale
            total = 0.0
            for i in range(len(slices)):
                seq = getattr(self.net, f"slice{i + 1}")
                x0, x1 = seq(x0), seq(x1)
                # eps after the sqrt, as the lpips package's
                # normalize_tensor
                n0 = x0 / (torch.sqrt((x0 ** 2).sum(dim=1, keepdim=True))
                           + 1e-10)
                n1 = x1 / (torch.sqrt((x1 ** 2).sum(dim=1, keepdim=True))
                           + 1e-10)
                total = total + getattr(self, f"lin{i}")(
                    (n0 - n1) ** 2).mean(dim=(2, 3), keepdim=True)
            return total

    return LPIPS()


def _build_lpips(net, weights_path, device):
    """lpips_module(net) with the state dict at `weights_path` loaded
    strictly, frozen, on `device`."""
    import torch

    model = lpips_module(net)
    state = torch.load(weights_path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model.to(device)


# (net, weights path, device) -> the model, or None after a failed build
_LPIPS_MODELS = {}


def lpips(pred, target, min_target_val, max_target_val, net="alex",
          weights_path=None, device="cpu"):
    """LPIPS of (B, C, H, W) images normalized by the target range to
    [-1, 1] (a single channel repeated three times), on `device`. Returns
    None without weights, or when the net cannot be built."""
    if weights_path is None:
        return None
    import torch

    device = torch.device(device)
    key = (net, str(weights_path), str(device))
    if key not in _LPIPS_MODELS:
        try:
            _LPIPS_MODELS[key] = _build_lpips(net, weights_path, device)
        except Exception as e:  # noqa: BLE001 - a metric, not the run
            print(f"LPIPS unavailable ({e}); recording NaN", flush=True)
            _LPIPS_MODELS[key] = None
    model = _LPIPS_MODELS[key]
    if model is None:
        return None
    rng = max_target_val - min_target_val
    p = 2 * (pred - min_target_val) / rng - 1
    t = 2 * (target - min_target_val) / rng - 1
    p = torch.from_numpy(np.ascontiguousarray(p)).float().to(device)
    t = torch.from_numpy(np.ascontiguousarray(t)).float().to(device)
    if p.shape[1] == 1:
        p = p.expand(-1, 3, -1, -1)
        t = t.expand(-1, 3, -1, -1)
    with torch.no_grad():
        return float(model(p, t).mean())


def compute_all(pred, target, min_target_val, max_target_val,
                lpips_net="alex", lpips_weights_path=None, device="cpu"):
    """All metrics for one (C, H, W) image pair; returns a dict."""
    pred = np.asarray(pred, np.float64)[None]
    target = np.asarray(target, np.float64)[None]
    rng = max_target_val - min_target_val
    out = {
        "l1": l1(pred, target),
        "psnr": psnr(pred, target, rng),
        "ssim": ssim(pred, target, max_target_val),
    }
    lp = lpips(pred, target, min_target_val, max_target_val, lpips_net,
               lpips_weights_path, device)
    out["lpips"] = float("nan") if lp is None else lp
    return out
