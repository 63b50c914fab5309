"""dcn_node_roofline.infer: the least bf16 forward time of the
configuration's own DCNv2 nodes at the batch's shapes, over the device
time of the dcn_fwd kernels (with their split-K reduction), per forward.
The node shapes (H, W, Cin, Cout) come from the configuration's
reference network, run once on the meta device at its input size; each
node's bound is roofline.node_bound_ms.  On DLA-34 the bound is
roofline.forward_bound_ms's; on resdcn_101 it is its three nodes'."""
import collections

import torch

from benchmark import roofline
from benchmark.reference import nets
from benchmark.reference.dcn import DCNv2


def node_shapes(conf: dict) -> dict:
    """{(H, W, Cin, Cout): nodes of that shape} of one forward of the
    configuration's reference network at its input size, in the order
    the forward first reaches each shape."""
    shapes = collections.Counter()

    def seen(mod, inp, out):
        _, cin, h, w = inp[0].shape
        shapes[(h, w, cin, out.shape[1])] += 1

    with torch.device("meta"):
        net = nets.build(conf).eval()
        for m in net.modules():
            if isinstance(m, DCNv2):
                m.register_forward_hook(seen)
        with torch.no_grad():
            net(torch.empty(1, 3, conf["input_h"], conf["input_w"]))
    return dict(shapes)


def bound_ms(conf: dict, batch: int) -> float:
    """The nodes' least forward time (bf16) for a batch."""
    return sum(n * roofline.node_bound_ms(s, batch)
               for s, n in node_shapes(conf).items())


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(("dcn_fwd",))
    if ms <= 0:
        return None
    batch = ctx.cell["traffic"]["batch"]
    forwards = ctx.units / batch
    return 100.0 * bound_ms(ctx.cell["config"], batch) * forwards / ms
