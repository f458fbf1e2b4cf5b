"""The harness of the firefoam_torch benchmark (benchmark/run.py)."""
