"""The port's scripts (run each as `python3 tools/<name>.py`); a package so
that the smoke test, the tests and the scripts import one another as
`tools.<name>` (the repo root's bench.py is the JAX package's)."""
