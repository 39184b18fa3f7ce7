"""``idle_share.score``: % of an untraced request's host time in which
no kernel, copy or set ran on the device: one less the device's busy time a
traced request over the mean host time of the window's untraced requests."""
from bench import readers

SPANS = {}


def read(ctx):
    return readers.idle_share(ctx)
