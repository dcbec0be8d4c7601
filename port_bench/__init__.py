"""The benchmark of ``vae_extent_search_tpu_torch`` (see README.md)."""
