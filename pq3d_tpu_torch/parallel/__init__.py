"""parallel of pq3d_tpu_torch (see the package docstring)."""
