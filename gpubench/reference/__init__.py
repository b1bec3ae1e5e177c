"""The plain PyTorch reference that decides ``correct``, and its control."""
