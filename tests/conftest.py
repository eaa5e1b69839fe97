"""Test bootstrap: puts src/ on sys.path.

Deliberately does NOT set XLA_FLAGS / device counts — unit tests must see
the real single CPU device.  Multi-device behaviour is exercised through
subprocess tests (tests/multidev/), each of which sets
``--xla_force_host_platform_device_count`` before importing jax.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips without them")
