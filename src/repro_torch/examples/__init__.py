"""The reference's examples as port modules (``python -m
repro_torch.examples.<name>``)."""
