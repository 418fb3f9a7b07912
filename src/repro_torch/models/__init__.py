"""Dense decoder in PyTorch (layers and model assembly)."""
