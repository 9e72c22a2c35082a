"""Reference of the ``local_morans_i``: Local Moran's I: the kNN graph, the observed I, z and lag, the total-permutation null's p per cell, and the post-pass (Benjamini-Hochberg over the cells of each gene, the quadrants)."""

from portbench.reference import common

LOCAL = True
sample = common.sample


def expected(section, traffic, seed, smp, lower=False):
    return common.expected(section, traffic, seed, smp, local=LOCAL,
                           lower=lower)


def readings(out, ref, section, smp, traffic):
    return common.readings(out, ref, section, smp, traffic, local=LOCAL)
