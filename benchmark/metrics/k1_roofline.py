"""Layer: kernels, K1 (``lasp_tpu_torch.ops.cuda_gossip.
gossip_round_dense``, ``csrc/gossip_round_dense.cu``).

K1's share of the HBM roofline, in %: the bytes of every launch in the
window (from the port's launch-shape counters, each input read once and
each output written once: ``harness.roofline.dense_bytes``) at the card's
published peak, over K1's device time in the trace. Moves
``converge_s``."""

from benchmark.harness import roofline

NAME = "k1_roofline"
KERNELS = ("gossip_round_dense",)


def install(ctx) -> None:
    ctx.own[NAME] = roofline.shapes_now()


def read(ctx):
    before = ctx.own.get(NAME)
    if before is None:
        return None
    return roofline.share(KERNELS, roofline.shapes_since(before), ctx.trace,
                          ctx.device_name)
