"""Parity harness: independent host-side oracles of the reference semantics
(with the pinned deterministic tie-break) for validating the device kernels.

``oracle.py`` (NumPy level loop) and ``heap_oracle.py`` (event-driven
claiming on a heap) are copies of the JAX package's; the native C++ engine
(``oracle.cc``) and its ctypes binding (``native.py``) are imported on
their own, so that importing this package builds nothing."""

from .oracle import oracle_transform, oracle_find_local_minima

__all__ = ["oracle_transform", "oracle_find_local_minima"]
