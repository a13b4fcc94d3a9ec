"""GLM training over a regularization path."""
