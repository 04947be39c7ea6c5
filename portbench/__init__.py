"""The benchmark of ``renderengine_tpu_torch`` (see README.md)."""
