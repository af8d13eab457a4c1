"""Device kernels of the port (K1-K3) and the tiers built on them."""
