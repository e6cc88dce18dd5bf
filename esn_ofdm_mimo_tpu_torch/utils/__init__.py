"""Device policy, key-compatible RNG, weight conversion and the kernel build."""
