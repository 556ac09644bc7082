"""The share (%) of the block products ``bsmm`` runs whose block of B is
live: the program's counters ``bsmm.blocks_useful`` over
``bsmm.blocks_multiplied``."""
from mmbench import spans


def read(view):
    return spans.counter_share(view, "bsmm.blocks_useful",
                               "bsmm.blocks_multiplied")
