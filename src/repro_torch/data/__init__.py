"""Streaming workload generators and their device packing."""
