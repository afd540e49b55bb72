"""Critic and VAE as NCHW ``nn.Module``s (eval forward)."""
