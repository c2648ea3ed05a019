"""Host C++ runtime of the port (csrc/host/, loaded by runtime/native.py)."""
