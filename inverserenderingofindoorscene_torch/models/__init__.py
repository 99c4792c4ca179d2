"""Network architectures (NCHW ``nn.Module``s with the reference's names)."""
