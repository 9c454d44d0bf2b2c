"""Profiling helpers of the port."""
