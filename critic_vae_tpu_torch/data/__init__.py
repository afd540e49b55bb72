"""Episode data: the synthetic generator and the X.npy/Y.npy loader (numpy)."""
