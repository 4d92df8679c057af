"""PNN training on one card: optimizer, checkpoints, loop, monitor."""
