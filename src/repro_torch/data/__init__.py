"""Synthetic point clouds for training and tests."""
