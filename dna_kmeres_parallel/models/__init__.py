"""Engines: NumPy golden oracle and the device engine/pipeline."""
