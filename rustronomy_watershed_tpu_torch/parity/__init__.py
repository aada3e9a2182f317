"""The native C++ engine of the reference semantics (``oracle.cc``) and its
ctypes binding (``native.py``)."""
