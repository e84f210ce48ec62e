"""Host-side arithmetic shared by kernels and models (precision policy, strip-mining)."""
