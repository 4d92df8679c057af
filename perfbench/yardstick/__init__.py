"""Frozen arithmetic of the benchmark: copies of the program's generators
and counts, kept here so that a change to the program cannot move them."""
