"""Test-support utilities shipped with the port (no pytest dependency)."""
