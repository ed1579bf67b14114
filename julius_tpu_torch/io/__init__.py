"""Model and file formats (host side; copies of julius_tpu.io modules)."""
