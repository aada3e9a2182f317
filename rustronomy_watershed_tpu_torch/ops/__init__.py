"""Tensor ops and kernel wrappers of the segmenting main path."""
