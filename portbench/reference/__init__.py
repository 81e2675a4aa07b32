"""The plain reference: plain PyTorch in float32, importing nothing of the system under test."""
