"""Native (C++) host runtime of the port, bound with ctypes."""
