"""Residual errors of every region polished in the window against the
simulated truth (the region's truth span widened by 400 b on each side;
``check.residual_errors``, a NumPy Smith-Waterman), per kb of polished
output.  Read in every run; reported as a per-layer metric because its
spread from seed to seed (a few errors in some tens of kb) is wider than
any end-to-end bound could be."""


def read(run):
    return run.errors_per_kb
