"""``idle_share.train``: % of an untraced step's host time in which
no kernel, copy or set ran on the device: one less the device's busy time a
traced step over the mean host time of the window's untraced steps."""
from bench import readers

SPANS = {}


def read(ctx):
    return readers.idle_share(ctx)
