"""k2_roofline.train (%), layer "kernels": K2's (``select.cu``) share of
its bound over the traced steps, as ``k1_roofline.train`` (bytes in
``exchange_bytes``). Only in the exchange's cells. Moves
train_tokens_per_s."""
from bench.metrics.exchange_bytes import roofline


def read(run):
    return roofline(run, "k2", "blockselect")
