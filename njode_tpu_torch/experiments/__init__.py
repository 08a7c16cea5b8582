"""The published experiment grids (configs.py) for the sweep runner."""
