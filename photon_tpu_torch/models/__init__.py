"""GLM model containers."""
