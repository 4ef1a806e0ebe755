"""The benchmark of tmgcn_torch (see run.py)."""
