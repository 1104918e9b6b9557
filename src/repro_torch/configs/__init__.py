"""Configs: the assigned architectures + the paper's Table III zoo."""
