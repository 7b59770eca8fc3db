"""100 x (1 - the union of device activity / the window's wall), from the
torch.profiler trace of the window."""

from psq_benchmark.metrics._common import idle_share


def read(run):
    return idle_share(run)
