"""The benchmark of lp_mp_tpu_torch (see run.py)."""
