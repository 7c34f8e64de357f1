"""Run directories and logs, checkpoints, and image files."""
