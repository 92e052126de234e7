"""Command-line tools of ccs_tpu_torch (run with ``python -m``)."""
