"""Layer: kernels, K2 and K3 (``lasp_tpu_torch.ops.cuda_gossip.
gossip_round_rows`` and ``gossip_round_rows_vclock``,
``csrc/gossip_round_rows.cu``), the frontier's sparse rounds.

A lower bound of their share of the HBM roofline, in %: the bytes by the
rule of ``harness.roofline`` (the targets' rows in and out, index entries
and flags) at the card's published peak, over their device time in the
trace. The neighbour rows they gather are not counted, since how many
distinct rows they are depends on the data and not on the launch's shape,
so the share read is a floor under the true one. Moves the cell's
end-to-end time."""

from benchmark.harness import roofline

NAME = "k2k3_roofline"
KERNELS = ("gossip_round_rows", "gossip_round_rows_vclock")


def install(ctx) -> None:
    ctx.own[NAME] = roofline.shapes_now()


def read(ctx):
    before = ctx.own.get(NAME)
    if before is None:
        return None
    return roofline.share(KERNELS, roofline.shapes_since(before), ctx.trace,
                          ctx.device_name)
