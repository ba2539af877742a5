"""op_census.count_ops on the CPU: operators are counted by the layer
whose call is in progress, and in the backward by the layer whose forward
made the autograd node being run; the weight chain's plain version (the
CPU's) runs hundreds of operators each way."""

import torch

from deblur_e_nerf_tpu_torch import op_census
from deblur_e_nerf_tpu_torch.ops import pb_weight


def test_count_ops_by_layer_and_direction():
    gen = torch.Generator().manual_seed(0)
    params = torch.tensor([2e-5, 0.02, 0.2, 1e-4, 3e-4, 8e-4, 1e-4],
                          requires_grad=True)
    it = (torch.rand((12, 3), generator=gen) + 0.1).requires_grad_()
    dt = torch.rand((11, 3), generator=gen) * 1e6 + 1e5
    g = torch.randn((12, 3, 2), generator=gen)

    def step():
        w = pb_weight.weight(params * 1.0, it, dt, 2)
        (w * g).sum().backward()
        return w

    counts, w = op_census.count_ops(step)
    assert w.shape == (12, 3, 2)
    chain = counts["B8 weight chain"]
    # the plain chain forward, then its checkpointed recompute and backward
    assert chain["forward"] > 100 and chain["backward"] > chain["forward"]
    # params * 1.0 and the loss ran outside every layer, both ways
    assert counts["other"]["forward"] >= 3
    assert counts["other"]["backward"] >= 2
    assert set(counts) == {"B8 weight chain", "other"}
    assert it.grad is not None and params.grad is not None
