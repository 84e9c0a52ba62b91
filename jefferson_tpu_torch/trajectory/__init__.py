"""Positions and trajectories (copies of ``jefferson_tpu.trajectory``)."""
