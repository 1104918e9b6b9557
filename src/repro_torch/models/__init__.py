"""The LM zoo in PyTorch: configs, layers, attention, transformer."""
