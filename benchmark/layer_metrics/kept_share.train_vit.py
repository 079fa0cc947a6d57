"""Share of a transformer training window's mined images that mining's
extraction served from the batches it kept on the device, in %: read as
``kept_share.train_cnn`` reads it."""

from benchmark.harness.core import metric_reader


def read(run):
    return metric_reader("kept_share.train_cnn").read(run)
