"""VAE training: the train step, Adam behind the non-finite guard, and its multi-step loop."""
