"""The Lanczos recurrence in plain PyTorch."""
