"""Reference of the ``streaming_moran_null``: Global Moran's I: the kNN graph, the observed I and the permutation null (p, and the null's mean and standard deviation where the entry returns them)."""

from portbench.reference import common

LOCAL = False
sample = common.sample


def expected(section, traffic, seed, smp, lower=False):
    return common.expected(section, traffic, seed, smp, local=LOCAL,
                           lower=lower)


def readings(out, ref, section, smp, traffic):
    return common.readings(out, ref, section, smp, traffic, local=LOCAL)
