"""r1_roofline.<cells>: R1's share of its roofline in a traced trainer run,
in %, for every split of the quantity (``.train`` on the 5x4 training,
``.contract`` on the 11x7 contract); see
``perfbench/harness/rmplus_counts.py`` for the count."""
from perfbench.harness import rmplus_counts


def read(ctx):
    return rmplus_counts.share(ctx)
